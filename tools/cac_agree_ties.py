"""chip_smoke.py's cac_agree on its own rows, again and again, on one CUDA
card: whether the phase's check holds in each run, and how far the
kernel's step lies from the plain attention's next to how far it lies from
the kernel's own first step on the same rows (the step run twice: what
the card's sums in a changing order move, which the kernel has no part
in) and from the steps on the points in other orders (the phase's floor).
CAC over the semseg file's PT-v3m1 takes no branch that rounding could
tip (mean pooling, GELU, CE, conf_thresh 0), so a gradient that moves far
from run to run sums many terms that nearly cancel.

    python3 tools/cac_agree_ties.py [runs]

runs cac_agree ``runs`` times (4 by default) with the card's default
scatter-adds, whose order changes from run to run (the phase's own
deterministic mode held off), then as many times under deterministic
algorithms (warn_only), as the phase runs its steps. Prints the card's
name and power limit first, a JSON line a run, and last a JSON list of
them: PASS or the check that failed, the worst
gradient distance and the floor the bound is built on, and the 5 tensors
furthest from the plain step with their distance from the kernel's first
step and their own floor.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SEEN = {}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("cac_agree_ties: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    records = []
    cs.emit = records.append
    grad_floor, compare_steps = cs.grad_floor, cs.compare_steps

    def seen_floor(ref, others):
        SEEN["first"] = ref
        SEEN["floor"] = grad_floor(ref, others)
        return SEEN["floor"]

    def seen_compare(phase, got, ref, **kw):
        SEEN["kernel"], SEEN["plain"] = got, ref
        return compare_steps(phase, got, ref, **kw)

    cs.grad_floor, cs.compare_steps = seen_floor, seen_compare
    runs = []
    n = int(argv[0]) if argv else 4
    set_mode = torch.use_deterministic_algorithms
    for i in range(2 * n):
        deterministic = i >= n
        set_mode(deterministic, warn_only=True)
        torch.use_deterministic_algorithms = lambda *args, **kwargs: None
        SEEN.clear()
        try:
            cs.phase_cac_agree()
            result = "PASS"
        except AssertionError as e:
            result = f"FAIL: {e}"
        finally:
            torch.use_deterministic_algorithms = set_mode
            set_mode(False)
        phase = next(r for r in reversed(records) if r.get("phase") == "cac_agree")
        kernel, plain, first = (SEEN[k][1] for k in ("kernel", "plain", "first"))
        own_floor = SEEN["floor"][0]
        total = torch.linalg.vector_norm(torch.stack([g.norm() for g in plain.values()]))
        rows = []
        for k, g in plain.items():
            if g.norm() < cs.ZERO_GRAD * total:
                continue
            rows.append(dict(tensor=k, kernel_vs_plain=cs.rel_l2(kernel[k], g),
                             kernel_vs_first=cs.rel_l2(kernel[k], first[k]),
                             own_floor=own_floor[k]))
        rows.sort(key=lambda r: -r["kernel_vs_plain"])
        run = dict(run=i, deterministic=deterministic, result=result,
                   worst_grad_rel_l2=phase.get("worst_grad_rel_l2"),
                   noise_floor_worst=phase.get("noise_floor_worst"),
                   bound=cs.NOISE_FLOOR_FACTOR * phase.get("noise_floor_worst", 0.0),
                   worst_kernel_vs_first=max(r["kernel_vs_first"] for r in rows),
                   furthest=rows[:5])
        print(json.dumps(run), flush=True)
        runs.append(run)
        torch.cuda.empty_cache()
    print(json.dumps(runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
