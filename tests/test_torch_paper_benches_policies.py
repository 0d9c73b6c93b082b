"""The port's Table 8 / Fig 17 (``bench_qssf``) and Table 9 / Figs 11-16
(``bench_policies``: the base rows, the ``pro``, ``naive`` and
``inspector`` variants on all three traces, slurm-mf BSLD) against the
reference's on the CPU, with the reference's cached agents: the CSV rows
string for string, Fig 17 at its quick size of 2,048 consecutive Philly
jobs.  The set-up is ``test_torch_paper_benches.py``'s."""
import pytest

from test_torch_paper_benches import benches, one_thread, run_both  # noqa: F401


@pytest.mark.parametrize("name", ["qssf", "policies"])
def test_paper_bench_rows_are_the_reference_rows(benches, capsys, name):
    want, got = run_both(benches, capsys, name)
    assert len(want) > 0
    assert got == want
