"""`repro_torch.program` — ahead-of-time resolved GAN executables.

The port of ``repro.program``:

* :class:`ProgramSpec` (:mod:`repro_torch.program.spec`) — ``build(cfg,
  batch, role)`` walks the layers **once** and freezes a tuple of
  :class:`LayerExec` records (geometry, fused epilogue, the resolved
  concrete backend, provenance).  Specs round-trip through the
  reference's JSON format, and the reference's files load with their
  backends mapped to the port's.
* :class:`Program` (:mod:`repro_torch.program.runtime`) — binds a spec
  to a device: ``apply(params, x)`` plus ``describe()``.
* :func:`load_or_build` — the degrading loader: corrupt / stale /
  mismatched program files fall back to fresh resolution.
* :func:`build_bucket_programs` — a bucket set from one frozen spec,
  every bucket mapped to the one program (nothing compiles per shape).
* ``python -m repro_torch.program <model>`` — build + describe (and
  export/load) programs from the command line.
"""

from repro_torch.program.runtime import (Program, build_bucket_programs,
                                         load_or_build)
from repro_torch.program.spec import (PROGRAM_FORMAT_VERSION, LayerExec,
                                      ProgramSpec)

__all__ = ["LayerExec", "Program", "ProgramSpec", "load_or_build",
           "build_bucket_programs", "PROGRAM_FORMAT_VERSION"]
