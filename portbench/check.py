"""The comparison that decides ``correct``: the program's first training
steps against the reference's, number by number, each against its limit
(``limits/<cell>.json`` names the numbers a cell compares).

Gradients, parameter changes and BatchNorm statistics are compared leaf by
leaf: a leaf's gap is the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf. Each comes as the worst leaf's gap and the median leaf's:

- ``loss1_gap`` / ``loss_gap``: the relative gap of ``loss_total`` at the
  first step / the largest over the steps;
- ``grad_gap`` / ``grad_median_gap``: the first step's gradient, the
  program's read from Adam's first moment after one step (a leaf that only
  one side moves reads 1);
- ``change_gap`` / ``change_median_gap``: each parameter's change over the
  checked steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves those by round-off alone);
- ``bn_gap`` / ``bn_median_gap``: each BatchNorm statistic's change, where
  the reference's statistics move at all;
- ``loader_gap`` (cells fed by the port's loader): the elements in which
  the loader's batches differ from the reference's own decode of the files.
"""

from __future__ import annotations

import statistics


def _gaps(prog: dict, ref: dict, keys) -> list:
    """Each leaf's gap: |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    ref_vals = sorted(ref.get(k, 0.0) for k in keys)
    floor = ref_vals[len(ref_vals) // 2] if ref_vals else 0.0
    out = []
    for k in keys:
        r, p = ref.get(k, 0.0), prog.get(k, 0.0)
        den = max(r, floor)
        gap = abs(p - r) / den if den > 0 else float(p != r)
        out.append(float("inf") if gap != gap else gap)
    return out


def _worst_and_median(gaps: list) -> tuple[float, float]:
    if not gaps:
        return 0.0, 0.0
    return max(gaps), statistics.median(gaps)


def readings(mine: dict, ref: dict) -> dict:
    """The check's numbers for a program's and a reference's steps."""
    lp, lr = mine["losses"], ref["losses"]
    gaps = [abs(p - r) / abs(r) for p, r in zip(lp, lr)]
    ok = len(lp) == len(lr) and all(g < float("inf") for g in gaps)
    out = {"loss1_gap": gaps[0] if ok else float("inf"),
           "loss_gap": max(gaps) if ok else float("inf")}
    g_p = dict(zip(mine["names"], mine["grad"].tolist()))
    g_r = dict(zip(ref["names"], ref["grad"].tolist()))
    keys = sorted(set(g_p) | set(g_r))
    out["grad_gap"], out["grad_median_gap"] = _worst_and_median(_gaps(g_p, g_r, keys))
    med = statistics.median([g_r.get(k, 0.0) for k in keys]) if keys else 0.0
    moved = [k for k in keys if g_r.get(k, 0.0) >= 1e-3 * med]
    c_p = dict(zip(mine["names"], mine["change"].tolist()))
    c_r = dict(zip(ref["names"], ref["change"].tolist()))
    out["change_gap"], out["change_median_gap"] = _worst_and_median(_gaps(c_p, c_r, moved))
    b_r = dict(zip(ref["bn_names"], ref["bn_change"].tolist()))
    if any(v > 0 for v in b_r.values()):
        b_p = dict(zip(mine["bn_names"], mine["bn_change"].tolist()))
        out["bn_gap"], out["bn_median_gap"] = _worst_and_median(
            _gaps(b_p, b_r, sorted(set(b_p) | set(b_r))))
    return out


def compare(mine: dict, ref: dict, limits: dict) -> dict:
    """{number: {"value", "limit"}} for every training number the limits
    name; a number the run cannot read reads infinite."""
    got = readings(mine, ref)
    return {k: {"value": got.get(k, float("inf")), "limit": lim} for k, lim in limits.items()
            if k != "loader_gap"}


def batch_mismatch(program_batches, reference_batches) -> float:
    """``loader_gap``: the elements (frames' bytes, K and K^-1 entries) in
    which the batches the program's loader gave differ from the ones the
    reference decoded itself; a missing batch counts as wholly different."""
    bad = 0
    for i, ref in enumerate(reference_batches):
        got = program_batches[i] if i < len(program_batches) else None
        for j, r in enumerate(ref):
            if got is None or tuple(got[j].shape) != tuple(r.shape):
                bad += r.numel()
            else:
                bad += int((got[j].cpu() != r).sum())
    return float(bad)


def holds(name: str, number: dict) -> bool:
    if name == "window_loss_finite":
        return number["value"] >= number["limit"]
    return number["value"] <= number["limit"]
