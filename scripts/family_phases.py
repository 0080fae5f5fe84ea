"""chip_smoke.py's phases 10-13 alone (after phase 3's flash check):
olmoe-1b-7b, mamba2-130m, internvl2-2b and whisper-medium served whole on
one card, every reading taken.  The cross-check limits are not applied
here (chip_smoke applies them), so a run reports its readings whatever
they are.

    python3 scripts/family_phases.py OUT_DIR [FAMILIES]

FAMILIES is a comma-separated subset of moe,ssm,vlm,encdec (default: all
four).  Needs a CUDA device.  Writes OUT_DIR/phases_10_13.json.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("family_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build_all
    out = argv[0]
    os.makedirs(out, exist_ok=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    build_all()
    res = {"flash": cs.check_flash_attention(dev,
                                             np.random.default_rng(2019))}
    for fam in cs.FAMILY_TOL:
        cs.FAMILY_TOL[fam] = {k: float("inf") for k in cs.FAMILY_TOL[fam]}
    cs.SSM_CONTINUE_TOL = float("inf")
    rc = 0
    fams = argv[1].split(",") if len(argv) == 2 else list(cs.FAMILY_SERVE)
    for fam in fams:
        t0 = time.perf_counter()
        try:
            res[fam], res[f"{fam}_launches"] = cs.family_phase(fam, dev)
        except Exception:  # report the phase's failure, run the next
            traceback.print_exc()
            rc = 1
        print(f"{fam}: {time.perf_counter() - t0:.1f} s", flush=True)
    with open(os.path.join(out, "phases_10_13.json"), "w") as fh:
        json.dump(res, fh, indent=1, default=str)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
