// The unified GANAX conv/tconv kernel for Hopper (sm_90a), planar, with an
// instance per storage dtype (f32, bf16, f16).
//
// Replaces: ganax_conv_kernel / ganax_conv_pallas (with
// apply_epilogue_to_acc) in src/repro/kernels/ganax_conv.py, the 2-D
// Pallas TPU kernel.  It computes the same function with the same
// phase-major output contract:
//
//   out[b, p, qy, qx, n] = act(bias[n] + sum_{t < n_taps[p]} sum_c
//       x_pad[b, tap_dy[p,t] + qy*sy, tap_dx[p,t] + qx*sx, c]
//       * w_taps[p, t, c, n])
//
// The Pallas kernel takes its x and w blocks in whatever dtype they come
// in, sums in an f32 scratch and casts once at the flush; so do these.
// The kernels are the rank-2 instances of ganax_conv_sm90.cuh, whose
// note says what bounds each layer on the card and what the three
// routes (tc: 3xTF32 wgmma fed by TMA and cp.async; narrow: a row-dot
// FFMA kernel for Cout <= 8; split-K with a fixed-order reduce) do
// about it.

#include "ganax_conv_sm90.cuh"

// Launches on `stream` without synchronising; returns what ganax::run
// returns (0 when every launch was accepted).  `bias` (f32) may be null;
// w is (P, T, Cin, Cout) (narrow), b_hi / b_lo the tc route's (P, Cout,
// kb) weights in tiles block_n wide (at f32 split into tf32 hi and lo, at
// bf16/f16 one operand in b_hi, b_lo unused), scratch (splits,
// B*P*Qy*Qx, Cout) f32 when splits > 1.  x, w, b_hi, b_lo and out are of
// the instance's storage type: ganax_conv_f32 (float), ganax_conv_bf16
// (__nv_bfloat16), ganax_conv_f16 (__half).
#define GANAX_CONV_ENTRY(SUFFIX, ST)                                         \
  extern "C" int ganax_conv_##SUFFIX(                                        \
      const ST* x, const ST* w, const ST* b_hi, const ST* b_lo,              \
      const int* n_taps, const int* tap_dy, const int* tap_dx,               \
      const float* bias, ST* out, float* scratch, int B, int Hp, int Wp,     \
      int Cin, int P, int T_, int Cout, int Qy, int Qx, int sy, int sx,      \
      int route, int block_n, int splits, int kb, int act, float slope,      \
      void* stream) {                                                        \
    ganax::Geom<2> g;                                                        \
    g.B = B;                                                                 \
    g.Cin = Cin;                                                             \
    g.P = P;                                                                 \
    g.T = T_;                                                                \
    g.Cout = Cout;                                                           \
    g.S[0] = Hp;                                                             \
    g.S[1] = Wp;                                                             \
    g.Q[0] = Qy;                                                             \
    g.Q[1] = Qx;                                                             \
    g.st[0] = sy;                                                            \
    g.st[1] = sx;                                                            \
    g.n_taps = n_taps;                                                       \
    g.tap[0] = tap_dy;                                                       \
    g.tap[1] = tap_dx;                                                       \
    return ganax::run<2, ST>(g, x, w, b_hi, b_lo, bias, out, scratch, route, \
                            block_n, splits, kb, act, slope, stream);        \
  }

GANAX_CONV_ENTRY(f32, float)
GANAX_CONV_ENTRY(bf16, __nv_bfloat16)
GANAX_CONV_ENTRY(f16, __half)
