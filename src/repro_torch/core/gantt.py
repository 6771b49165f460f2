"""ASCII Gantt rendering of simulated schedules — the paper's Figs. 2–4/6–7 as
runnable artifacts.

Block-sparse (ragged) schedules render too: EMPTY tiles never appear (they are
absent from the chains by construction), and tasks on PARTIAL tiles — the ones
the kernels mask-multiply — draw as ``%`` hatching instead of their q digit, so
a glance at the chart shows where masking cost lives. :func:`render_block_map`
draws the mask's tile classification itself.

Port of ``repro.core.gantt``: every string equals the reference's character
for character (``tests/test_torch_simulator.py``).
"""
from __future__ import annotations

from repro_torch.core.schedules import Schedule
from repro_torch.core.simulator import SimResult, simulate


def render(schedule: Schedule, result: SimResult = None, c: float = 1.0,
           r: float = 0.5, width: int = 100) -> str:
    """One row per worker; digits = q-tile id during compute (``%`` if the
    tile is PARTIAL under the schedule's mask), '-' = blocked waiting for its
    reduction turn (the deterministic-order stall — the paper's bubbles),
    '#' = reduction phase, '.' = idle."""
    if result is None:
        result = simulate(schedule, c, r)
    span = result.makespan
    scale = width / span
    partial = set(schedule.partial_cells)
    rows = []
    for w, chain in enumerate(schedule.chains):
        row = ["."] * width
        for task in chain:
            cs, rs, re = result.task_times[task]
            ce = cs + c
            _, kv, q = task
            glyph = "%" if (kv, q) in partial else str(q % 10)
            for col in range(int(cs * scale), min(width, int(ce * scale))):
                row[col] = glyph
            for col in range(int(ce * scale), min(width, int(rs * scale))):
                row[col] = "-"
            for col in range(int(rs * scale), min(width, int(re * scale))):
                row[col] = "#"
        rows.append(f"W{w:02d} |" + "".join(row) + "|")
    mask_tag = f" mask={schedule.mask_key}" if schedule.mask_key else ""
    head = (f"{schedule.name} causal={schedule.causal} n={schedule.n_workers} "
            f"m={schedule.n_heads}{mask_tag} | makespan={result.makespan:.1f} "
            f"util={result.utilization:.2f}")
    return head + "\n" + "\n".join(rows)


def render_block_map(mask, n_kv: int, n_q: int, block_q: int = 128,
                     block_k: int = 128) -> str:
    """The mask's tile classification as a (kv rows × q cols) grid:
    '#' = FULL, '%' = PARTIAL (mask-multiplied), '.' = EMPTY (elided from
    grids and schedules entirely)."""
    from repro_torch.masks.spec import EMPTY, PARTIAL
    bm = mask.block_map(n_kv, n_q, block_q, block_k)
    glyph = {EMPTY: ".", PARTIAL: "%"}
    lines = [f"{mask.key()}  ({n_kv}x{n_q} tiles, {block_k}x{block_q} tokens)"]
    for kv in range(n_kv):
        lines.append(f"KV{kv:02d} |" + "".join(
            glyph.get(int(bm[kv, q]), "#") for q in range(n_q)) + "|")
    return "\n".join(lines)


def compare(n: int = 8, m: int = 2, c: float = 1.0, r: float = 0.5,
            causal: bool = True) -> str:
    """Side-by-side rendering of the applicable schedules (paper Fig. 3 vs 4
    vs 7 for causal; Fig. 3 vs 6 for full)."""
    from repro_torch.core import schedules as S
    names = (["fa3", "descending", "symmetric_shift"] if causal
             else ["fa3", "shift"])
    blocks = []
    for nm in names:
        sch = (S.fa3(n, m, causal) if nm == "fa3"
               else S.descending(n, m, causal) if nm == "descending"
               else S.make_schedule(nm, n, m, causal))
        blocks.append(render(sch, c=c, r=r))
    return "\n\n".join(blocks)


def compare_masked(mask, n_kv: int, n_q: int, block_q: int = 128,
                   block_k: int = 128, c: float = 1.0, r: float = 0.5) -> str:
    """Block map + shift vs fa3-order placement Gantts for one mask — the
    ragged analogue of :func:`compare`."""
    from repro_torch.masks.schedule import compile_block_schedule
    blocks = [render_block_map(mask, n_kv, n_q, block_q, block_k)]
    for placement in ("fa3", "shift"):
        sch = compile_block_schedule(mask, n_kv, n_q, block_q, block_k,
                                     placement=placement)
        blocks.append(render(sch, c=c, r=r))
    return "\n\n".join(blocks)
