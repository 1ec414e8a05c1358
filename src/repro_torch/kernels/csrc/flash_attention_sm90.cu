// Forward flash attention for Hopper (sm_90a) on the tensor cores: bf16
// storage at head dims 64, 80, 128 and 256, and at q.k head dim 96
// against value head dim 64; f32 scores, softmax and sums.
//
// Replaces: _fa_kernel / flash_attention_pallas in
// src/repro/kernels/flash_attention.py, the Pallas TPU kernel, for the
// bf16 geometries of the LLM configs the port serves (Gemma-7B, hd 256;
// Qwen1.5-32B and InternVL2-26B, hd 128; Hymba-1.5B's global layers, hd
// 64; HuBERT-XLarge's non-causal layers, hd 80; MiniCPM3-4B's multi-head
// latent attention, q and k of 64 + 32 against v of 64).  f32
// storage, bf16 at hd 8-32 and the tiny split pair (48, 32) stay on the
// FFMA kernel of flash_attention.cu.  It computes the same function (dk
// the head dim of q and k, dv that of v and out; hd = dk = dv but at
// (96, 64)):
//
//   out[b, i, h, :] = sum_j p[i, j] v[b, j, h, :] / max(sum_j p[i, j], 1e-30)
//   s[i, j] = dk^-0.5 (q[b, i, h, :] . k[b, j, h, :]), soft-capped to
//             c tanh(s / c) when the cap c is > 0, then -1e30 where the
//             causal mask (i >= j, indices aligned top-left) hides j
//   p[i, j] = exp(s[i, j] - max_j s[i, j]), kept by an online softmax
//
// The soft-cap (Gemma's logit soft-capping, the reference's `softcap`) is
// a template flag: the instances without it are the same code as before
// it existed.  The kernel is a template on (dk, dv): the instances at
// dk = dv are the code they were before the split one existed.
//
// What bounds it on the card: a causal prefill of S tokens does about
// S^2 (dk + dv) FLOPs of q.k^T and p.v per head against 2 S (dk + dv)
// elements of q, k, v and out, so at every instance here, with S from
// the low hundreds, it is bound by arithmetic.  Here q.k^T and p.v
// both run as bf16 wgmma with f32 sums (989 TFLOP/s dense on an H100
// SXM), p.v twice (below), so the tensor-core work is dk + 2 dv a score
// (three times q.k^T's at dk = dv; 224 against the bound's 160 at (96,
// 64), 192 against 128 at hd 64, 336 against 160 at hd 80, whose second
// v panel is 64 wide for 16 real columns).  At dv 64 the softmax, whose work a
// score does not shrink with the head dims, takes a larger share of the
// consumers' issue slots than at hd 256, and the largest at hd 64.
//
// Numerics, and why this is the TPU kernel's function:
// * The tensor cores multiply bf16 exactly, but they do not add in IEEE
//   f32: adding a wgmma's products into an accumulator that already
//   holds a larger sum drops low bits.  Chained over the 16 slices of
//   hd 256 for q.k^T, and over every kv tile for p.v, that moved some
//   outputs of a Gemma-7B prefill (its own q, k, v: scores in the
//   hundreds, outputs up to ~10) past two bf16 ulps of the f32 plain
//   version, where near-tied p's or cancelling terms amplify it.  So no
//   accumulator runs long: each 16-wide slice of hd goes to the tensor
//   cores into a fresh accumulator and the slices are summed in f32
//   FADDs, and each kv tile's p.v goes, one 64-column panel of v at a
//   time, into a fresh accumulator that is added to the output in f32.
//   A wgmma then only adds one 16-product slice to a sum of its own
//   tile; every longer sum is IEEE f32, in another order than the
//   reference's.
// * q.k^T: the scale dk^-0.5 goes on the f32 scores after the product
//   (exact at hd 256 and 64, where it is 2^-4 and 2^-3; at hd 128 and
//   dk 96 it differs from the reference's pre-scaled q by f32
//   rounding).  p = exp(s - m) with s - m taken first, as the reference
//   does.
// * p stays f32 through the softmax (m, l, alpha in f32, l summed from
//   the f32 p).  For p.v it is split into two bf16 values,
//   p_hi = bf16_rn(p) and p_lo = bf16_rn(p - p_hi), and the tile's p.v
//   is p_hi.v + p_lo.v.  With 2^e <= p < 2^(e+1), p - p_hi is exact in
//   f32 and at most half a bf16 ulp of p, 2^(e-8); p_lo rounds it to
//   bf16's 8 significant bits, so |p - p_hi - p_lo| <= 2^(e-17) <=
//   2^-17 p.  v is bf16, so every product is exact in f32.  The result
//   is p.v up to the order of the sums and a relative error of at most
//   2^-17 per term, far below the one rounding of the bf16 output.
//   Rounding p to bf16 once (as SDPA does) would be another function.
// * Masked scores are -1e30; out = acc / max(l, 1e-30), cast once.
//
// Design:
// * A block computes BQ = 128 query rows of one (batch, head), with
//   three warpgroups: warpgroup 0 is the producer (one thread issues TMA;
//   setmaxnreg gives the group 24 registers a thread), warpgroups 1 and 2
//   are consumers of 64 rows each (the wgmma M), at 240 registers a
//   thread.  Each consumer keeps its 64 x dv f32 output in registers
//   (dv/2 a thread: 128 at hd 256, 40 at hd 80, 32 at dv 64).
// * The kv tile is BK = 64 rows at hd 128 and 256.  At hd 256 a consumer
//   thread holds the output (128 registers), the 64 x 64 f32 scores (32),
//   one fresh wgmma accumulator (32) and the bf16 p_hi and p_lo fragments
//   (32, live with the scores' last use and the accumulator of p.v, not
//   with the one of q.k^T): about 200 with addresses and the softmax
//   state, of the 240.  Every wgmma is m64n64k16.  At dv 64 ((96, 64)
//   and (64, 64)) the output is 32 registers, so the kv tile is 128
//   keys: q.k^T is m64n128k16, the scores and their fresh accumulator 64
//   registers each, and a tile's dk/16 waits on q.k^T slices (6 at dk
//   96, 4 at 64) cover twice the keys; p.v stays m64n64k16, 2 BK/16 of
//   them a tile.  Both consumers then walk the same tiles (BK = BQ).
// * At dv 64 a score costs the tensor cores 224 products at (96, 64) and
//   192 at (64, 64) but still one exp2f and the rounding of p to p_hi
//   and p_lo, which share the SM's narrow conversion pipe: there p is
//   split by packed conversions (split_bf16x2: the same bits as
//   split_bf16, half the conversions).  So is it at hd 80, whose kv tile
//   of 64 keys a score costs 336 products: measured on one H100 against
//   split_bf16 (tools/flash_variants.py --hd 80), 0.0849 against 0.0931
//   ms at (1, 1500, 16) and 0.2190 against 0.2372 at (2, 2048, 16), 27.87
//   against 27.04 at (1, 32768, 16); a kv tile of 128 keys was slower at
//   all three.
// * Shared memory: the q tile (128 x hd bf16, 64 KB at hd 256), loaded
//   once, and a ring of two stages of k and v (BK x hd bf16 each, 32 KB
//   at hd 256): 192 KB at hd 256, 96 KB at hd 128, 80 KB at hd 64 (BK
//   128), one block an SM (the consumers' registers).
//   Every tile is stored as panels of 64 columns, rows of 128 bytes with
//   the 128-byte swizzle, as TMA writes it and as wgmma reads it.  At dk
//   96, q and k take two panels, the second half empty (columns 96-127,
//   see TMA): 32 KB of q and 32 KB of k a stage at BK 128 in place of 24
//   and 24, for one descriptor layout and one box shape for every
//   operand, and each 16-wide slice of dk inside one panel; v and the
//   output are one panel; 128 KB in all at BK 128.  At hd 64 every
//   operand is one panel, a row exactly 128 bytes, with nothing to fill.
//   At hd 80 every operand takes two panels, columns 80-127 of the second
//   filled with zeros: q and k as at dk 96 (5 slices of 16, the fifth in
//   the second panel), v and the output as at hd 128 (two panels, BK 64:
//   q 32 KB, k and v 16 KB each a stage, 96 KB in all).  p.v runs over
//   the second panel's full 64 columns (a 64-wide MN-major operand is
//   what the 128-byte swizzle takes) and keeps the accumulator's first
//   8 registers a thread, columns 64-79; the rest multiply TMA's zeros
//   and are dropped.
// * TMA: one tensor map per operand over (its head dim, S or T, H, B),
//   built on the host from the strides the wrapper is given, so the (B,
//   S, H, hd) views need no copy (MLA's v, every other 64 columns of the
//   expanded kv, included).  The box is 64 x rows (the 128-byte swizzle
//   allows 64 bf16 across), so a row of hd loads as ceil(hd/64) boxes.
//   What lies past the tensor arrives as zeros and reads no memory: rows
//   past S or T (keys past T are masked like the causal mask, query rows
//   past S are computed and never stored), q's and k's columns 96-127
//   at dk 96 (no wgmma reads them) and every operand's columns 80-127 at
//   hd 80 (read by the second panel's p.v and dropped with its
//   products).  The expected bytes of a barrier
//   count the whole boxes, as TMA does.
// * Pipeline: the producer loads q, then for each live kv tile waits for
//   its stage to be empty, and loads k and v onto their own full
//   barriers.  A consumer waits for k, runs q.k^T (dk/16 wgmmas), scales
//   and masks the scores (only tiles that cross the diagonal or the end
//   of T are masked), runs the online softmax on the accumulator layout
//   (each row over a quad of threads: shuffles for the max; the sums are
//   reduced at the end), rescales its output, splits p into p_hi/p_lo
//   fragments in registers (the accumulator layout of the scores is the
//   A-fragment layout of p.v), waits for v, runs p.v (A from registers,
//   B = v, MN-major: 2 BK/16 wgmmas a panel), and releases the stage
//   once wgmma.wait_group has retired them.  The two consumers overlap
//   each other's softmax and f32 adds with their wgmmas.
// * The causal live-block bound is the reference's, n_live = min(ceil((q0
//   + BQ) / BK), ceil(T / BK)); the first consumer's rows end 64 earlier,
//   and it skips the tiles past its own bound (all masked for its rows,
//   so skipping them changes nothing).
// * Grid (B*H, ceil(S/128)), with the q tiles in reverse order: the
//   heaviest causal tiles start first.
// * Epilogue: each consumer normalises, casts to bf16, writes its rows
//   into its own (now free) part of the q tile's first dv/64 panels in
//   the same swizzled layout (the output's panels are q's, dv <= dk), and
//   one thread stores them with TMA by the output's tensor map, which
//   clips the rows past S and the columns past dv (at hd 80, the second
//   panel's columns 80-127, which would be the next head's).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;              // query rows a block
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kPanel = 64;            // bf16 columns of a 128-byte row
constexpr float kNegInf = -1e30f;     // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int DK, int DV>
struct Sm90Tiles {
  static_assert((DK == DV && (DK == 64 || DK == 80 || DK == 128 ||
                              DK == 256)) ||
                    (DK == 96 && DV == 64),
                "the wgmma kernel takes hd 64, 80, 128, 256 and (dk, dv) "
                "(96, 64)");
  // a 64-wide output (dv 64: (64, 64) and (96, 64)) leaves the consumers
  // the registers for a kv tile of 128 keys; hd 80, 128 and 256 keep 64
  static constexpr bool kNarrowV = DV == kPanel;
  static constexpr int BK = kNarrowV ? 128 : 64;  // keys a kv tile
  static constexpr int kStages = 2;
  // q and k in ceil(DK/64) panels, v and the output in ceil(DV/64) (at
  // DK 96 the second panel's last 32 columns lie past the tensor's edge,
  // at hd 80 its last 48: TMA fills them with zeros)
  static constexpr int kPanelsQK = (DK + kPanel - 1) / kPanel;
  static constexpr int kPanelsV = (DV + kPanel - 1) / kPanel;
  static_assert(kPanelsV * kPanel >= DV, "v's panels cover dv");
  static_assert(kPanelsV <= kPanelsQK, "the output's panels are q's");
  static constexpr int kQBytes = kBQ * kPanelsQK * kPanel * 2;
  static constexpr int kKBytes = BK * kPanelsQK * kPanel * 2;  // a stage
  static constexpr int kVBytes = BK * kPanelsV * kPanel * 2;   // a stage
  static constexpr int kTileBytes = kQBytes + kStages * (kKBytes + kVBytes);
  // 1024 bytes of slack to align the tiles to the swizzle atom, then the
  // barriers: q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kSmemBytes = 1024 + kTileBytes + 8 * (1 + 3 * kStages);
  // p split by packed conversions (split_bf16x2) at dv 64 and hd 80
  static constexpr bool kPackedSplit = kNarrowV || DV == 80;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Waits for the phase of `bar` with this parity to complete.  (A timeout
// that traps here would cost the consumers their registers: with it,
// ptxas spills and serialises the wgmmas.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// -- TMA ----------------------------------------------------------------------
// One box of the 4-d map (hd, rows, H, B) at (c0, c1, c2, c3) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------
// The shared-memory matrix descriptor of a tile stored as 128-byte rows
// with the 128-byte swizzle, 8-row groups 1024 bytes apart (the stride
// byte offset).  Every wgmma here reads one such panel along its M or N
// (64 bf16), so the leading byte offset, the stride between panels, is
// unused.  The low 14 bits are the address / 16: the descriptor of a
// slice further into the tile is this one plus the slice's offset / 16.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(16 >> 4) << 16)      // leading, unused
         | (static_cast<uint64_t>(1024 >> 4) << 32)    // stride
         | (1ull << 62);                               // 128-byte swizzle
}
// Returns x as a value the compiler may not treat as known: descriptors
// made from it inside the kv loop are not hoisted out of the loop, where
// the hd/16 descriptors of an operand would hold registers throughout.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins a register-held accumulator around the asynchronous wgmmas, so
// the compiler neither reads nor moves it while they run.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 64, f32) = a (64 x 16, from its descriptor) . b (64 x 16, from its
// descriptor), both K-major; d's old value is neither read nor kept.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}
// The same at N = 128: d (64 x 128, f32), b 128 x 16.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 64, f32) = a (64 x 16, bf16 in registers) . b (16 x 64, from its
// descriptor, MN-major: the transpose bit); d's old value is neither
// read nor kept.
__device__ __forceinline__ void wgmma_rs_zero(float (&d)[32],
                                     const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
// The same with d += a . b.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c tanh(s / c), the soft-cap, as c sign(x) (1 - e) / (1 + e) with
// e = exp(-2 |x|), x = s / c: branch-free, a handful of instructions
// (tanhf's range reduction cost the consumer 2.8x at hd 256 and spilled).
// e is within a few f32 ulps, so the result is within ~1e-7 c of tanh,
// below the rounding of an f32 score.
__device__ __forceinline__ float softcap_score(float s, float cap) {
  const float x = __fdividef(s, cap);
  const float e = exp2f(-2.f * kLog2e * fabsf(x));
  return copysignf(cap * __fdividef(1.f - e, 1.f + e), x);
}

// Two f32 values of p as bf16 pairs: hi = bf16_rn(x), lo = bf16_rn(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}
// The same bits by two packed conversions (cvt.rn.bf16x2.f32), each
// rounding both values: half split_bf16's conversions, which share the
// SM's narrow conversion and exp2 pipe.
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The accumulator layout of a 64 x N wgmma (f32): thread `lane` of warp w
// of the warpgroup holds, for each 8-column chunk j, d[4j + e] at row
// 16w + lane/4 (e = 0, 1) or that row + 8 (e = 2, 3), column 8j +
// 2 (lane % 4) + (e & 1).  For a 16-wide slice kk of the scores, the A
// fragment of the p.v wgmma is exactly the pairs (d[8kk + 2i],
// d[8kk + 2i + 1]), i = 0..3, packed as bf16: no data leaves the thread.
template <int DK, int DV, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
fa_sm90_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, int H, int S, int T,
               int causal, float sm_scale, float softcap) {
  using Tl = Sm90Tiles<DK, DV>;
  constexpr int BK = Tl::BK;
  constexpr int kStages = Tl::kStages;
  constexpr int kRowBytes = kPanel * 2;  // 128
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // q: [panel][kBQ rows][128 B]; k and v: [stage][panel][BK rows][128 B]
  uint8_t* ks = qs + Tl::kQBytes;
  uint8_t* vs = ks + kStages * Tl::kKBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * Tl::kVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int n_kv = (T + BK - 1) / BK;
  const int n_live = causal ? min((q0 + kBQ + BK - 1) / BK, n_kv) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // -- producer: one thread keeps the k/v stages in flight ------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Tl::kQBytes);
      for (int p = 0; p < Tl::kPanelsQK; ++p)
        tma_load(qs + p * kBQ * kRowBytes, &tq, q_full, p * kPanel, q0, h,
                 b);
      for (int it = 0; it < n_live; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* kd = ks + st * Tl::kKBytes;
        uint8_t* vd = vs + st * Tl::kVBytes;
        mbar_expect_tx(&k_full[st], Tl::kKBytes);
        for (int p = 0; p < Tl::kPanelsQK; ++p)
          tma_load(kd + p * BK * kRowBytes, &tk, &k_full[st], p * kPanel,
                   it * BK, h, b);
        mbar_expect_tx(&v_full[st], Tl::kVBytes);
        for (int p = 0; p < Tl::kPanelsV; ++p)
          tma_load(vd + p * BK * kRowBytes, &tv, &v_full[st], p * kPanel,
                   it * BK, h, b);
      }
    }
  } else {
    // -- consumers: 64 query rows each ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int lt = threadIdx.x - 128 * wg;
    const int warp = lt >> 5;
    const int lane = lt & 31;
    const int t4 = lane & 3;
    const int row_base = q0 + 64 * cw;
    const int rl0 = 16 * warp + (lane >> 2);  // this thread's rows in the
    const int rl1 = rl0 + 8;                  // warpgroup's 64
    const int my_live =
        causal ? min((row_base + 64 + BK - 1) / BK, n_kv) : n_kv;
    uint8_t* q_wg = qs + cw * 64 * kRowBytes;  // in each q panel
    const uint64_t desc_q = smem_desc(q_wg);

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_live; ++it) {
      const int st = it % kStages;
      const int ph = (it / kStages) & 1;
      mbar_wait(&k_full[st], ph);
      if (it < my_live) {
        const uint8_t* kt = ks + st * Tl::kKBytes;
        const uint8_t* vt = vs + st * Tl::kVBytes;
        // s = q . k^T over dk, f32: each 16-wide slice of dk on the
        // tensor cores into a fresh accumulator, the slices summed here
        // in f32 (see the note on numerics)
        const uint64_t dq = opaque(desc_q);
        const uint64_t dk = smem_desc(kt);
        float s[BK / 2];
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const int p = kk / 4;
          const int sub = (kk % 4) * 32;  // 16 bf16 into the 128-byte row
          const uint64_t da = dq + ((p * kBQ * kRowBytes + sub) >> 4);
          const uint64_t db = dk + ((p * BK * kRowBytes + sub) >> 4);
          if (kk == 0) {
            wgmma_fence();
            wgmma_ss(s, da, db);
            wgmma_commit();
            fence_regs(s);
            wgmma_wait_all();
            fence_regs(s);
          } else {
            float t[BK / 2];
            wgmma_fence();
            wgmma_ss(t, da, db);
            wgmma_commit();
            fence_regs(t);
            wgmma_wait_all();
            fence_regs(t);
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) s[i] += t[i];
          }
        }

        // scale, soft-cap, mask, online softmax on the accumulator layout
        const int k0 = it * BK;
        const bool edge = k0 + BK > T || (causal && k0 + BK - 1 > row_base);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] *= sm_scale;
        if constexpr (kSoftcap) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) s[i] = softcap_score(s[i], softcap);
        }
        if (edge) {
          const int r0 = row_base + rl0;
          const int r1 = row_base + rl1;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = k0 + 8 * j + 2 * t4 + e;
              if (c >= T || (causal && c > r0)) s[4 * j + e] = kNegInf;
              if (c >= T || (causal && c > r1)) s[4 * j + 2 + e] = kNegInf;
            }
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float alpha0 = exp2f((m0 - mx0) * kLog2e);
        const float alpha1 = exp2f((m1 - mx1) * kLog2e);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
        uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // fragment register i holds row rl0 (i even) or rl1 (i odd).
            // s - m first, as the reference: it is exact where p matters
            // (s near m), and scores of the model's own q/k reach the
            // thousands, where s log2e - m log2e would lose bits of p
            const float mx = (i & 1) ? mx1 : mx0;
            const float x0 = exp2f((s[8 * kk + 2 * i] - mx) * kLog2e);
            const float x1 = exp2f((s[8 * kk + 2 * i + 1] - mx) * kLog2e);
            if (i & 1)
              sum1 += x0 + x1;
            else
              sum0 += x0 + x1;
            if constexpr (Tl::kPackedSplit)
              split_bf16x2(x0, x1, p_hi[kk][i], p_lo[kk][i]);
            else
              split_bf16(x0, x1, p_hi[kk][i], p_lo[kk][i]);
          }
        }
        // per-thread partial sums; the quad's are added at the end
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o[4 * j] *= alpha0;
          o[4 * j + 1] *= alpha0;
          o[4 * j + 2] *= alpha1;
          o[4 * j + 3] *= alpha1;
        }

        // o += p.v = p_hi.v + p_lo.v, one 64-column panel of v at a time
        // on the tensor cores into a fresh accumulator, added to o here
        // in f32 (see the note on numerics)
        mbar_wait(&v_full[st], ph);
        const uint64_t dv = smem_desc(vt);
#pragma unroll
        for (int pn = 0; pn < Tl::kPanelsV; ++pn) {
          float t[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t db =
                dv + (((pn * BK + kk * 16) * kRowBytes) >> 4);
            if (kk == 0)
              wgmma_rs_zero(t, p_hi[kk], db);
            else
              wgmma_rs(t, p_hi[kk], db);
            wgmma_rs(t, p_lo[kk], db);
          }
          wgmma_commit();
          fence_regs(t);
          wgmma_wait_all();
          fence_regs(t);
          // a panel past dv's last (hd 80's second) keeps its real
          // columns, the accumulator's first (DV - 64 pn) / 2 registers
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (32 * pn + i < DV / 2) o[32 * pn + i] += t[i];
        }
      }
      // this warp no longer reads the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // -- epilogue: normalise, cast once, store by TMA ----------------------
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float den0 = fmaxf(l0, 1e-30f);
    const float den1 = fmaxf(l1, 1e-30f);
    // every wgmma of this warpgroup has retired: its 64 rows of the q
    // tile are free, and take the output in the same swizzled layout
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      uint8_t* panel = q_wg + (j / 8) * kBQ * kRowBytes;
      const int c = j % 8;
      *reinterpret_cast<uint32_t*>(
          panel + rl0 * kRowBytes + ((c ^ (rl0 & 7)) << 4) + 4 * t4) =
          pack_bf16(__float2bfloat16_rn(o[4 * j] / den0),
                    __float2bfloat16_rn(o[4 * j + 1] / den0));
      *reinterpret_cast<uint32_t*>(
          panel + rl1 * kRowBytes + ((c ^ (rl1 & 7)) << 4) + 4 * t4) =
          pack_bf16(__float2bfloat16_rn(o[4 * j + 2] / den1),
                    __float2bfloat16_rn(o[4 * j + 3] / den1));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
    if (lt == 0 && row_base < S) {
      for (int p = 0; p < Tl::kPanelsV; ++p)
        tma_store(&to, q_wg + p * kBQ * kRowBytes, p * kPanel, row_base, h,
                  b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        p == nullptr)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of one (B, rows, H, D) operand, viewed as (D, rows, H, B) by
// its element strides, in boxes of 64 x box_rows with the 128-byte
// swizzle; out-of-bounds rows, and columns past D, read as zeros and are
// not written.
CUresult make_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B,
                  int rows, int H, int D, const long long* st,
                  int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  // st: (batch, position, head) element strides; the map takes bytes of
  // dims 1..3
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kPanel, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DK, int DV, bool SC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int S, int Tk, const long long* st, int causal,
           float sm_scale, float softcap, cudaStream_t stream) {
  using Tl = Sm90Tiles<DK, DV>;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, out};
  const int rows[4] = {S, Tk, Tk, S};
  const int widths[4] = {DK, DK, DV, DV};
  const int boxes[4] = {kBQ, Tl::BK, Tl::BK, 64};
  for (int i = 0; i < 4; ++i) {
    const CUresult r = make_map(fn, &maps[i], ptrs[i], B, rows[i], H,
                                widths[i], st + 3 * i, boxes[i]);
    if (r != CUDA_SUCCESS) return -(1000 * (i + 1) + static_cast<int>(r));
  }
  constexpr int smem = Tl::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_sm90_kernel<DK, DV, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  fa_sm90_kernel<DK, DV, SC><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], H, S, Tk, causal, sm_scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

// The instance at (DK, DV) with the soft-cap flag that `softcap` asks for.
template <int DK, int DV>
int launch_capped(const void* q, const void* k, const void* v, void* out,
                  int B, int H, int S, int Tk, const long long* st,
                  int causal, float sm_scale, float softcap,
                  cudaStream_t stream) {
  return softcap > 0.f
             ? launch<DK, DV, true>(q, k, v, out, B, H, S, Tk, st, causal,
                                    sm_scale, softcap, stream)
             : launch<DK, DV, false>(q, k, v, out, B, H, S, Tk, st, causal,
                                     sm_scale, 0.f, stream);
}

}  // namespace

// Launches on `stream` without synchronising.  Returns 0 when the launch
// was accepted, a CUDA runtime error (> 0), -1 when the driver has no
// cuTensorMapEncodeTiled, or -(1000 (i + 1) + r) when encoding the
// tensor map of operand i (q, k, v, out) failed with CUresult r.
// q, k, v, out are bf16; D is the head dim of q and k, Dv that of v and
// out: (64, 64), (80, 80), (128, 128), (256, 256) or (96, 64); strides:
// 12 element
// strides, (batch, position, head) of q, k, v and out in that order; the
// head dim is contiguous.  softcap: 0 for none, else the cap c of s -> c
// tanh(s / c).
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int H, int S, int Tk, int D, int Dv,
                                        const long long* strides, int causal,
                                        float sm_scale, float softcap,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && Dv == 128)
    return launch_capped<128, 128>(q, k, v, out, B, H, S, Tk, strides,
                                   causal, sm_scale, softcap, s);
  if (D == 256 && Dv == 256)
    return launch_capped<256, 256>(q, k, v, out, B, H, S, Tk, strides,
                                   causal, sm_scale, softcap, s);
  if (D == 96 && Dv == 64)
    return launch_capped<96, 64>(q, k, v, out, B, H, S, Tk, strides, causal,
                                 sm_scale, softcap, s);
  if (D == 64 && Dv == 64)
    return launch_capped<64, 64>(q, k, v, out, B, H, S, Tk, strides, causal,
                                 sm_scale, softcap, s);
  if (D == 80 && Dv == 80)
    return launch_capped<80, 80>(q, k, v, out, B, H, S, Tk, strides, causal,
                                 sm_scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
