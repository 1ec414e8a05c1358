// The volumetric GANAX conv/tconv kernel for Hopper (sm_90a), with an
// instance per storage dtype (f32, bf16, f16).
//
// Replaces: ganax_conv3d_kernel / ganax_conv3d_pallas in
// src/repro/kernels/ganax_conv.py, the 3-D Pallas TPU kernel (the twin of
// the planar kernel that ganax_conv.cu ports).  It computes the same
// function with the same phase-major output contract:
//
//   out[b, p, qz, qy, qx, n] = act(bias[n] + sum_{t < n_taps[p]} sum_c
//       x_pad[b, tap_dz[p,t] + qz*sz, tap_dy[p,t] + qy*sy,
//             tap_dx[p,t] + qx*sx, c] * w_taps[p, t, c, n])
//
// The TPU kernel holds a whole padded volume of one image in VMEM (about
// 10 MB at g4); here the rank-3 instances of ganax_conv_sm90.cuh gather
// each row's window from device memory by its tap offsets.  That note
// says what bounds each layer and what the three routes do about it.
// 3D-GAN's wide layers (g1-g3, d2-d4) are bound by arithmetic and take
// the tc route; g4 and d1's dx (Cout = 1) the narrow one, which reads
// each padded input (644 MB at g4) about once from device memory; d5
// (K = 32,768, 64 outputs) splits K.

#include "ganax_conv_sm90.cuh"

// As ganax_conv_<dtype> (ganax_conv.cu), with a depth axis.
#define GANAX_CONV3D_ENTRY(SUFFIX, ST)                                       \
  extern "C" int ganax_conv3d_##SUFFIX(                                      \
      const ST* x, const ST* w, const ST* b_hi, const ST* b_lo,              \
      const int* n_taps, const int* tap_dz, const int* tap_dy,               \
      const int* tap_dx, const float* bias, ST* out, float* scratch, int B,  \
      int Dp, int Hp, int Wp, int Cin, int P, int T_, int Cout, int Qz,      \
      int Qy, int Qx, int sz, int sy, int sx, int route, int block_n,        \
      int splits, int kb, int act, float slope, void* stream) {              \
    ganax::Geom<3> g;                                                        \
    g.B = B;                                                                 \
    g.Cin = Cin;                                                             \
    g.P = P;                                                                 \
    g.T = T_;                                                                \
    g.Cout = Cout;                                                           \
    g.S[0] = Dp;                                                             \
    g.S[1] = Hp;                                                             \
    g.S[2] = Wp;                                                             \
    g.Q[0] = Qz;                                                             \
    g.Q[1] = Qy;                                                             \
    g.Q[2] = Qx;                                                             \
    g.st[0] = sz;                                                            \
    g.st[1] = sy;                                                            \
    g.st[2] = sx;                                                            \
    g.n_taps = n_taps;                                                       \
    g.tap[0] = tap_dz;                                                       \
    g.tap[1] = tap_dy;                                                       \
    g.tap[2] = tap_dx;                                                       \
    return ganax::run<3, ST>(g, x, w, b_hi, b_lo, bias, out, scratch, route, \
                            block_n, splits, kb, act, slope, stream);        \
  }

GANAX_CONV3D_ENTRY(f32, float)
GANAX_CONV3D_ENTRY(bf16, __nv_bfloat16)
GANAX_CONV3D_ENTRY(f16, __half)
