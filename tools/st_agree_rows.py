"""chip_smoke.py's st_agree on other rows, and with the KPConv distance the
port took before (``torch.linalg.vector_norm`` and a Python-scalar
divisor), on one CUDA card: that the phase holds on any rows (its float64
witness takes the card's branches at every kink and neighbour max, and
audits those it would not take as near ties), how many near ties the card
takes, and that the old distance lies as near the witness as the port's.

    python3 tools/st_agree_rows.py [seeds ...]

Each seeds argument is st_agree's ``a,b,c`` (semseg_rows' two room seeds
and jittered's); by default 41,42,43 (ST_AGREE_SEEDS) three times and five
others. Every set runs with the port's KPConv; the old distance then runs
on the first set and on the first whose floors both count. Prints the
card's name and power limit first, one line a run, and last a JSON list of
them: the card's, the CPU's and the swapped rows' whole-gradient
distances, which floors counted, the card's branches that the witness
would not take and the largest of their margins, and PASS or the check
that failed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from scenesplat_tpu_torch.models import stratified  # noqa: E402

DEFAULT_SEEDS = ["41,42,43", "41,42,43", "41,42,43", "44,45,46", "47,48,49", "51,52,53", "54,55,56", "57,58,59"]


def old_kpconv_forward(self, feat, neighbor_idx, coord, query_coord=None):
    """KPConv.forward with the distance the port took before."""
    g = stratified.po.grouping(neighbor_idx, feat.to(self.dtype), coord,
                               query_coord=query_coord, with_xyz=True)
    rel, gf = g[..., :3], g[..., 3:]
    d = torch.linalg.vector_norm(rel[..., None, :] - self.K_points.to(rel.dtype), dim=-1)
    infl = torch.clamp(1.0 - d / self.point_influence, min=0.0)
    infl = infl * (neighbor_idx >= 0)[..., None].to(infl.dtype)
    agg = torch.einsum("bnkp,bnkc->bnpc", infl.to(gf.dtype), gf)
    return torch.einsum("bnpc,pcd->bnd", agg, self.weight.to(gf.dtype))


def run(seeds, kpconv, records):
    """st_agree on rows ``seeds`` with ``kpconv`` (the name of the distance):
    the witness record's distances and the phase's outcome."""
    cs.ST_AGREE_SEEDS = seeds
    start = len(records)
    try:
        cs.phase_st_agree()
        result = "PASS"
    except AssertionError as e:
        result = f"FAIL: {e}"
    torch.cuda.empty_cache()
    witness = next((r for r in records[start:] if r.get("phase") == "st_agree_witness"), {})
    phase = next((r for r in records[start:] if r.get("phase") == "st_agree"
                  and "branch_decisions" in r), {})
    out = dict(seeds=seeds, kpconv=kpconv, result=result, **{k: witness.get(k) for k in (
        "card_to_witness_whole", "cpu_to_witness_whole", "other_orders_floor_whole",
        "in_floor")}, **{k: phase.get(k) for k in (
            "branch_decisions", "card_branches_not_witness", "worst_near_tie")})
    print(json.dumps(out), flush=True)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("st_agree_rows: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    records = []
    cs.emit = records.append
    sets = [tuple(int(v) for v in a.split(",")) for a in (argv or DEFAULT_SEEDS)]
    runs = [run(seeds, "direct", records) for seeds in sets]
    both = next((r["seeds"] for r in runs if r["in_floor"] and all(r["in_floor"].values())),
                None)
    stratified.KPConv.forward = old_kpconv_forward
    runs += [run(seeds, "vector_norm", records)
             for seeds in dict.fromkeys(s for s in (sets[0], both) if s)]
    print(json.dumps(runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
