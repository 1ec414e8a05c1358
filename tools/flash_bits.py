"""Digests of the flash-attention kernels' outputs, tree against tree, on
one CUDA card: does a change leave the kernels' bits as they were?

    python3 tools/flash_bits.py TREE [TREE ...]

Each TREE is a checkout of this repository (``.``, or another commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Each runs in a process of its own that builds that tree's
kernels and imports that tree's ``src/repro_torch``, launches each
case's launcher (``flash_attention_cuda``, or one kernel's own,
``flash_attention_ffma`` or ``flash_attention_wgmma``) as
``launcher(q, k, v, causal=)`` (no soft-cap: the call every tree takes)
on the inputs of :data:`CASES`, drawn from a seed on the host, and
prints one line ``BITS {json}``: the tree, the card's name and power
limit (``nvidia-smi``) and the SHA-256 of each output's bytes (or, for a
geometry that tree's launcher refuses, ``"refused: ..."``).  Equal
digests are equal bits.  ``tests/test_torch_cuda.py`` holds the kernels
at soft-cap 0 to the digests this script printed for the commit before
the soft-cap existed, on the cases it had then.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

# (label, B, S, T, H, hd, causal, dtype name, q/k scale, launcher): both
# kernels, both causal modes, ragged S and T, and scores large enough
# that the softmax saturates.  The launcher is the name of the wrapper
# in repro_torch.kernels.flash_attention: "flash_attention_cuda" (the
# variant table's choice), or one kernel's own where the table picks the
# other at that geometry (the FFMA bf16 hd-64 digest is pinned by the
# GPU tests).  A case's seed is its index, so new cases go at the end.
CASES = (("wgmma hd256 causal", 1, 300, 300, 4, 256, True, "bfloat16", 1.0,
          "flash_attention_cuda"),
         ("wgmma hd128 full ragged", 2, 150, 133, 2, 128, False, "bfloat16",
          1.0, "flash_attention_cuda"),
         ("wgmma hd256 big scores", 1, 200, 200, 2, 256, True, "bfloat16",
          4.0, "flash_attention_cuda"),
         ("ffma f32 hd256 causal", 1, 200, 200, 2, 256, True, "float32",
          1.0, "flash_attention_cuda"),
         ("ffma bf16 hd64 full ragged", 2, 150, 97, 3, 64, False, "bfloat16",
          1.0, "flash_attention_ffma"),
         ("ffma f32 hd32 causal", 2, 128, 128, 3, 32, True, "float32", 1.0,
          "flash_attention_cuda"),
         ("wgmma hd64", 2, 150, 97, 3, 64, True, "bfloat16", 1.0,
          "flash_attention_wgmma"),
         ("wgmma hd80", 2, 150, 97, 4, 80, False, "bfloat16", 1.0,
          "flash_attention_cuda"))


def digests(dev) -> dict[str, str]:
    """The SHA-256 of the case's launcher's output on each case's inputs
    (q, k, v drawn N(0, scale^2), N(0, scale^2), N(0, 1) on the host from
    seed case index + 1); ``"refused: ..."`` where the launcher raises
    ValueError on the geometry (a tree whose kernel is not built for
    it)."""
    import torch

    from repro_torch.kernels import flash_attention
    out = {}
    for i, (label, b, s, t, h, hd, causal, dname, scale, launcher) in \
            enumerate(CASES):
        gen = torch.Generator().manual_seed(i + 1)
        dtype = getattr(torch, dname)
        q, k, v = ((torch.randn(shape, generator=gen) * c).to(dev, dtype)
                   for shape, c in (((b, s, h, hd), scale),
                                    ((b, t, h, hd), scale),
                                    ((b, t, h, hd), 1.0)))
        try:
            o = getattr(flash_attention, launcher)(q, k, v, causal=causal)
        except ValueError as e:
            out[label] = f"refused: {e}"
            continue
        raw = o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        out[label] = hashlib.sha256(raw).hexdigest()
    return out


def _one(tree: Path) -> None:
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import build
    build.build(("flash_attention", "flash_attention_sm90"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print("BITS " + json.dumps({"tree": str(tree), "card": card,
                                "digests": digests(torch.device("cuda"))}))


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--one"]:
        _one(Path(args[1]).resolve())
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in args:
        run = subprocess.run([sys.executable, __file__, "--one", tree],
                             timeout=900)
        if run.returncode:
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
