"""Variants of one bf16 instance of the wgmma flash kernel, timed in
turns on one CUDA card: which kv tile, how many k/v stages, which p
split?

    python3 tools/flash_variants.py [--hd 64|80] [--rounds N]

Each variant is a copy of ``csrc/flash_attention_sm90.cu`` under
``build/flash_variants/`` (git-ignored) with the constants of
``Sm90Tiles<hd, hd>`` edited (:data:`VARIANTS` of the head dim; "shipped"
is the source as it is), compiled by ``nvcc`` with the port's flags, all
at once.  One process then swaps each variant's library in behind
``flash_attention_wgmma`` (the port's own wrapper, its checks and its
launch) and, round by round, in turns (the order reversed every other
round), times one launch at each of the head dim's :data:`GEOMETRIES`
(hd 64: Hymba-1.5B's global layers, its longest served prompt and its
training batch, causal; hd 80: HuBERT-XLarge's non-causal layers, its
longest utterance, its training batch and its 32,768-frame encode) as
the device runs it (``chip_smoke.device_ms``).  It holds each variant's
output against the plain version at ``chip_smoke.FLASH_TOL`` and prints
the SHA-256 of its bits, then one line ``VARIANTS {json}``: the card's
name and power limit, and per variant and geometry every round's ms and
the median.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_variants"
SOURCE = "flash_attention_sm90"

_BK = "  static constexpr int BK = kNarrowV ? 128 : 64;  // keys a kv tile\n"
_STAGES = "  static constexpr int kStages = 2;\n"
_SPLIT = "  static constexpr bool kPackedSplit = kNarrowV || DV == 80;\n"
# head dim -> name -> (text of the source, its replacement) edits; each
# applies to the (hd, hd) instance alone
VARIANTS = {
    64: {
        "shipped": (),
        "bk64": ((_BK, _BK.replace("kNarrowV ? 128", "kNarrowV && DK != 64 "
                                   "? 128")),),
        "stages3": ((_STAGES, _STAGES.replace("= 2", "= DK == 64 ? 3 : 2")),),
        "split_bf16": ((_SPLIT, _SPLIT.replace("kNarrowV", "kNarrowV && "
                                               "DK != 64")),),
    },
    80: {
        "shipped": (),
        "bk128": ((_BK, _BK.replace("kNarrowV ?", "kNarrowV || DK == 80 "
                                    "?")),),
        "split_bf16": ((_SPLIT, _SPLIT.replace("kNarrowV || DV == 80",
                                               "kNarrowV")),),
    },
}
# head dim -> (label, B, S, H, causal) in bf16
GEOMETRIES = {
    64: (("hymba serving", 1, 3814, 25, True),
         ("hymba training", 2, 2048, 25, True)),
    80: (("hubert utterance", 1, 1500, 16, False),
         ("hubert training", 2, 2048, 16, False),
         ("hubert 32k", 1, 32768, 16, False)),
}


def build_all(hd: int) -> dict[str, Path]:
    """Each variant's library at head dim ``hd``, compiled in parallel;
    raises on a failed build with nvcc's output."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / f"{SOURCE}.cu").read_text()
    procs = {}
    for name, edits in VARIANTS[hd].items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source does not hold "
                                   f"{old!r} once")
            src = src.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # ptxas's registers and spills of the (hd, hd) instances
        entry = ""
        for line in log.splitlines():
            if "entry function" in line or "Function properties" in line:
                entry = line
            elif f"fa_sm90_kernelILi{hd}ELi{hd}E" in entry:
                print(f"{name}: {line.strip()}")
        libs[name] = so
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hd", type=int, default=64, choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build_all(args.hd)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    geometries = GEOMETRIES[args.hd]
    causal = {label: c for label, _, _, _, c in geometries}
    inputs = {label: chip_smoke.flash_operands(b, s, s, h, args.hd,
                                               torch.bfloat16, dev, seed=s)
              for label, b, s, h, _ in geometries}
    # the plain version over larger tiles at the longest S (the same
    # function, summed in another f32 order; far fewer Python steps)
    refs = {label: fa.flash_attention_plain(
        *qkv, causal=causal[label],
        **(dict(block_q=1024, block_k=1024) if qkv[0].shape[1] > 4096
           else {}))
        for label, qkv in inputs.items()}
    atol, rtol = chip_smoke.FLASH_TOL[torch.bfloat16]

    def use(name: str) -> None:
        build._LOADED[SOURCE] = ctypes.CDLL(str(libs[name]))
        fa._library.cache_clear()

    times = {name: {label: [] for label in inputs} for name in libs}
    for name in libs:
        use(name)
        for label, qkv in inputs.items():
            got = fa.flash_attention_wgmma(*qkv, causal=causal[label])
            torch.cuda.synchronize()
            err = (got.float() - refs[label].float()).abs().max().item()
            ok = torch.allclose(got.float(), refs[label].float(), atol=atol,
                                rtol=rtol)
            bits = hashlib.sha256(got.view(torch.uint8).cpu().numpy()
                                  .tobytes()).hexdigest()[:16]
            print(f"{name} {label}: max_abs_err vs plain {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}, bits {bits}")
            if not ok:
                return 1
    order = list(libs)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            use(name)
            for label, qkv in inputs.items():
                times[name][label].append(chip_smoke.device_ms(
                    lambda: fa.flash_attention_wgmma(
                        *qkv, causal=causal[label])))
    for name, by_label in times.items():
        print(f"{name}: " + ", ".join(
            f"{label} median {statistics.median(t):.4f} ms "
            f"({', '.join(f'{x:.4f}' for x in t)})"
            for label, t in by_label.items()) + f" [{card}]")
    print("VARIANTS " + json.dumps({"card": card, "times": {
        name: {label: dict(ms=t, median=statistics.median(t))
               for label, t in by_label.items()}
        for name, by_label in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
