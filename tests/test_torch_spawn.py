"""``parallel.spawn``'s teardown and its failure report, on gloo ranks on
the CPU.

A process group that outlived the rank's function ran its native gloo
threads into the interpreter's exit, and the rank then aborted now and
then after sending its result ("terminate called without an active
exception", SIGABRT), which failed the spawn: the elastic supervisor's
generations and the pipeline's 4-rank world both failed that way.
``spawn``'s ranks now tear every group down before they exit
(``parallel.distributed._release_world``), so no gloo thread is left at
the exit of a rank that built a mesh, the hierarchical layout and a
reference cycle holding the default group. A rank that dies is reported
with its exit code or signal and the end of its stderr.
"""

import pytest

from distributed_mnist_bnns_tpu_torch.parallel import RankFailed, spawn
from tests import torch_dp_util as util


def test_no_gloo_thread_outlives_a_rank(tmp_path):
    assert spawn(util.teardown_threads_run, 2, backend="gloo",
                 device="cpu", args=(str(tmp_path),)) == [4.0, 4.0]
    left = {r: int((tmp_path / str(r)).read_text()) for r in (0, 1)}
    assert left == {0: 0, 1: 0}


@pytest.mark.parametrize("how, ended", [("exit", "exited with code 3"),
                                        ("abort", "signal SIGABRT")])
def test_a_dead_rank_is_named_with_its_exit_and_stderr(how, ended):
    with pytest.raises(RankFailed) as e:
        spawn(util.dies_run, 2, backend="gloo", device="cpu", args=(how,))
    msg = str(e.value)
    assert f"rank 1 (pid" in msg and ended in msg, msg
    assert f"rank 1 about to {how}" in msg, msg
    assert list(e.value.exits) == [1]
