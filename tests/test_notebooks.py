"""Committed walkthrough notebooks carry real executed outputs.

The reference's committed cell outputs are its de-facto golden values
(SURVEY §4); ours are produced by ``examples/make_notebooks.py`` which
executes every cell with nbclient before writing. These tests pin that
property — every committed .ipynb has outputs, none of them is an error,
and the headline golden numbers are present in the printed tables.
"""

import json
import os
import re

import pytest

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")

NOTEBOOKS = [
    "TransportPDEExample.ipynb",
    "ParabolicPDEExample.ipynb",
    "BrainTumor1DExample.ipynb",
    "TrafficPDEExample.ipynb",
]


def _load(name):
    path = os.path.join(EXAMPLES, name)
    if not os.path.exists(path):
        pytest.fail(f"missing committed notebook {name}")
    with open(path) as f:
        return json.load(f)


def _stream_text(nb):
    chunks = []
    for cell in nb["cells"]:
        for out in cell.get("outputs", []):
            if out.get("output_type") == "error":
                pytest.fail(
                    f"error output in committed notebook: "
                    f"{out.get('ename')}: {out.get('evalue')}"
                )
            if out.get("output_type") == "stream":
                chunks.append("".join(out.get("text", [])))
    return "\n".join(chunks)


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_is_executed_and_clean(name):
    nb = _load(name)
    code_cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert code_cells, "notebook has no code cells"
    assert any(c.get("outputs") for c in code_cells), "no executed outputs"
    assert all(c.get("execution_count") for c in code_cells), (
        "unexecuted code cell present"
    )
    _stream_text(nb)  # fails on any error output


def _table_value(text, row, col=1):
    """Value in printed `name | a | b` tables: col-th number on `row`'s line."""
    for line in text.splitlines():
        if row in line:
            cells = line.split("|")[1:]  # numbers live after the label column
            nums = re.findall(r"[-+]?\d+\.\d+", "|".join(cells))
            if len(nums) >= col:
                return float(nums[col - 1])
    pytest.fail(f"row {row!r} not found in notebook stream output")


def test_transport_golden_values():
    text = _stream_text(_load("TransportPDEExample.ipynb"))
    m = re.search(r"mean return over 256 episodes: ([-+]?\d+\.\d+)", text)
    assert m, "batched mean-return line missing"
    # published reference backstepping average is 243.06 (HyperbolicPDEExample)
    assert abs(float(m.group(1)) - 243.06) < 5.0
    # 3-way RL table (reference cells 13-15: 243.06 / 189.98 / 179.90); the
    # learned PPO policy beats the analytic backstepping controller
    assert _table_value(text, "ppo |") > _table_value(text, "backstepping |")
    assert _table_value(text, "sac |") > 179.90


def test_transport_fixed_ic_table():
    # reference cell 22's deterministic u0=1 / u0=10 rows. Backstepping
    # reproduces the published rewards to ~2 decimals (289.84 / 198.38);
    # our RL rows beat the published PPO 244.47 / 72.51 and SAC 217.33 /
    # 146.10 on both ICs
    text = _stream_text(_load("TransportPDEExample.ipynb"))
    rows = {}
    for line in text.splitlines():
        cells = [c.strip() for c in line.split("|")]
        if len(cells) == 4 and cells[0] in ("backstepping", "ppo", "sac"):
            rows[(cells[0], float(cells[1]))] = (float(cells[2]), float(cells[3]))
    assert abs(rows[("backstepping", 1.0)][0] - 289.84) < 0.5
    assert abs(rows[("backstepping", 10.0)][0] - 198.38) < 0.5
    assert rows[("ppo", 1.0)][0] > 244.47
    assert rows[("ppo", 10.0)][0] > 72.51
    assert rows[("sac", 1.0)][0] > 217.33
    assert rows[("sac", 10.0)][0] > 146.10


def test_parabolic_golden_values():
    text = _stream_text(_load("ParabolicPDEExample.ipynb"))
    # 50-episode means vs the reference's published table (±2% band: the
    # episode ICs are random but 50-episode means are tight)
    assert abs(_table_value(text, "backstepping") - 298.98) < 6.0
    assert _table_value(text, "ppo") > 285.0
    assert _table_value(text, "sac") > 233.11  # beats published SAC outright


def test_parabolic_fixed_ic_rl_rows():
    # reference cell 23's RL rows (published PPO 294.83 / 283.32, SAC
    # 236.04 / 232.75 for u0=1 / u0=10): ours beat all four
    text = _stream_text(_load("ParabolicPDEExample.ipynb"))
    rows = {}
    for line in text.splitlines():
        cells = [c.strip() for c in line.split("|")]
        if len(cells) == 4 and cells[0] in ("ppo", "sac"):
            rows[(cells[0], float(cells[1]))] = float(cells[2])
    assert rows[("ppo", 1.0)] > 294.83
    assert rows[("ppo", 10.0)] > 283.32
    assert rows[("sac", 1.0)] > 236.04
    assert rows[("sac", 10.0)] > 232.75


def test_brain_tumor_golden_values():
    text = _stream_text(_load("BrainTumor1DExample.ipynb"))
    paper = _table_value(text, "paper 1.8 Gy/day |")
    rl = _table_value(text, "RL (PPO) |")
    assert paper > 50.0  # fixed protocol extends survival
    assert rl > paper + 15.0  # reference claims RL beats protocols by >20 days


def test_traffic_golden_values():
    text = _stream_text(_load("TrafficPDEExample.ipynb"))
    bcks = _table_value(text, "backstepping |")
    ppo = _table_value(text, "ppo |")
    assert bcks < 0.0 and ppo < 0.0  # tracking penalties
    assert ppo > bcks  # learned policy beats the analytic outlet law


def test_transport_notebook_reexecutes_at_head():
    """Anti-drift: the transport notebook is RE-EXECUTED against current
    code (not just its committed outputs re-read) and must reproduce the
    same headline numbers. This makes silent divergence between committed
    goldens and HEAD mechanically impossible to miss; the other three
    notebooks' goldens are covered transitively (same envs/checkpoints,
    pinned by the committed-output tests above + examples smoke tests)."""
    import sys

    import nbformat
    from nbclient import NotebookClient

    sys.path.insert(0, EXAMPLES)
    try:
        import make_notebooks as mn
    finally:
        sys.path.remove(EXAMPLES)

    nb = mn.build(mn.TRANSPORT)
    # pin the spawned kernel to the CPU before any jax use, like the rest
    # of the suite, so it never takes an accelerator
    nb.cells.insert(0, nbformat.v4.new_code_cell(
        "import jax\njax.config.update('jax_platforms', 'cpu')"
    ))
    NotebookClient(nb, timeout=900, kernel_name="python3",
                   resources={"metadata": {"path": EXAMPLES}}).execute()

    text = "\n".join(
        "".join(o.get("text", []))
        for c in nb.cells for o in c.get("outputs", [])
        if o.get("output_type") == "stream"
    )
    m = re.search(r"mean return over 256 episodes: ([-+]?\d+\.\d+)", text)
    assert m, "batched mean-return line missing from fresh execution"
    assert abs(float(m.group(1)) - 243.06) < 5.0  # published reference band
    assert _table_value(text, "ppo |") > _table_value(text, "backstepping |")
    assert _table_value(text, "sac |") > 179.90
