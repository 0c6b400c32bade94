"""The port's lockstep checker over ``torch.distributed``
(``distributed_mnist_bnns_tpu_torch/analysis/spmd.py``) on the CPU: the
JAX package's tests/test_spmd.py cases on the port — the recorder's
ordered schedule, every replaced ``torch.distributed`` function put back
(on an exception too), shape-correct rank-aware stubs, the checker's
pass and fail cases, the seeded divergence mutant caught at its first
index — plus the refusals (a real process group, a second simulation),
and every shipped exchange in lockstep at worlds 2, 4, 8 and the
(hosts x local) meshes, each schedule the one the JAX package's plan
lays out (its programs' ops in torch's names).
"""

import threading

import pytest
import torch
import torch.distributed as dist

from distributed_mnist_bnns_tpu.ops.comm_compress import (
    make_plan as jax_make_plan,
)
from distributed_mnist_bnns_tpu_torch.analysis import spmd
from distributed_mnist_bnns_tpu_torch.analysis.spmd import (
    CollectiveOp,
    LockstepError,
    check_lockstep,
    record_schedule,
    run_lockstep,
    sim_group,
    verify_shipped,
)

ORIGINALS = {name: getattr(dist, name) for name in spmd.STUBBED}


def _put_back():
    return all(getattr(dist, n) is f for n, f in ORIGINALS.items())


# --------------------------------------------------------------------------
# recorder mechanics
# --------------------------------------------------------------------------


def test_recorder_captures_ordered_schedule_and_puts_dist_back():
    def prog(x):
        g = sim_group("data")
        dist.all_reduce(x, group=g)
        out = [torch.empty_like(x) for _ in range(4)]
        dist.all_gather(out, x, group=g)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=g)

    sched = record_schedule(prog, torch.ones(4, 8), world=4, pid=1)
    assert [c.op for c in sched] == ["all_reduce", "all_gather",
                                     "all_to_all_single"]
    assert [c.index for c in sched] == [0, 1, 2]
    assert sched[0].axis == "data" and sched[0].shape == (4, 8)
    assert sched[0].dtype == "torch.float32"
    assert _put_back()


def test_dist_is_put_back_after_an_exception():
    def prog():
        dist.barrier(group=sim_group())
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        record_schedule(prog, world=2, pid=0)
    assert _put_back()
    assert not dist.is_initialized()


def test_stubs_are_shape_correct_and_rank_aware():
    out = {}

    def prog(x):
        g = sim_group("data")
        out["rank"] = dist.get_rank(g)
        out["size"] = dist.get_world_size(g)
        out["flat"] = (dist.get_rank(), dist.get_world_size())
        s = x.clone()
        dist.all_reduce(s, group=g)
        out["sum"] = s
        gathered = torch.empty(4 * x.numel())
        dist.all_gather_into_tensor(gathered, x.reshape(-1), group=g)
        out["gathered"] = gathered
        share = torch.empty(2)
        dist.reduce_scatter_tensor(share, torch.arange(8.0), group=g)
        out["share"] = share
        b = x.clone()
        dist.broadcast(b, 0, group=g)
        out["bcast"] = b

    record_schedule(prog, torch.ones(3, 2), world=4, pid=2)
    assert out["rank"] == 2 and out["size"] == 4 and out["flat"] == (2, 4)
    assert torch.equal(out["sum"], torch.full((3, 2), 4.0))   # * world
    assert out["gathered"].shape == (24,)
    assert torch.equal(out["share"], torch.tensor([16.0, 20.0]))  # rank 2
    assert torch.equal(out["bcast"], torch.ones(3, 2))


def test_mesh_groups_take_their_axis_size_and_coordinate():
    seen = {}

    def prog():
        for axis in ("data", "local", ("data", "local"), None):
            g = sim_group(axis)
            seen[str(axis)] = (g.size, dist.get_rank(g))
        seen["first_of_data"] = dist.get_global_rank(sim_group("data"), 0)
        x = torch.ones(2)
        dist.all_reduce(x, group=sim_group("local"))
        seen["local_sum"] = float(x[0])

    record_schedule(prog, world={"data": 2, "local": 4},
                    pid={"data": 1, "local": 3})
    assert seen["data"] == (2, 1) and seen["local"] == (4, 3)
    assert seen["('data', 'local')"] == (8, 7) and seen["None"] == (8, 7)
    assert seen["first_of_data"] == 3   # (data 0, local 3)
    assert seen["local_sum"] == 4.0


def test_refuses_a_real_process_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="real process group"):
            record_schedule(lambda: None, world=2, pid=0)
    finally:
        dist.destroy_process_group()
    assert _put_back()


def test_refuses_a_second_simulation_in_another_thread():
    entered, release = threading.Event(), threading.Event()
    errors = []

    def hold():
        entered.set()
        release.wait(10)

    t = threading.Thread(
        target=lambda: record_schedule(hold, world=2, pid=0))
    t.start()
    entered.wait(10)
    try:
        record_schedule(lambda: None, world=2, pid=1)
    except RuntimeError as e:
        errors.append(str(e))
    release.set()
    t.join(10)
    assert errors and "another simulated process" in errors[0]
    assert _put_back()


def test_sim_group_outside_a_simulation_raises():
    with pytest.raises(RuntimeError, match="outside a simulated process"):
        sim_group("data")


# --------------------------------------------------------------------------
# the checker
# --------------------------------------------------------------------------


def test_lockstep_passes_on_identical_schedules():
    def prog(x):
        dist.all_reduce(x, group=sim_group("data"))

    check_lockstep([record_schedule(prog, torch.ones(4), world=2, pid=p)
                    for p in range(2)])


def test_lockstep_flags_mismatched_op_identity():
    a = [CollectiveOp(0, "all_reduce", "data", (4,), "torch.float32")]
    b = [CollectiveOp(0, "all_gather", "data", (4,), "torch.float32")]
    with pytest.raises(LockstepError) as e:
        check_lockstep([a, b])
    assert e.value.divergence_index == 0
    assert "all_reduce" in str(e.value) and "all_gather" in str(e.value)


def test_lockstep_flags_length_mismatch_at_shorter_end():
    base = [CollectiveOp(0, "all_reduce", "data", (4,), "torch.float32"),
            CollectiveOp(1, "all_gather", "data", (4,), "torch.float32")]
    with pytest.raises(LockstepError) as e:
        check_lockstep([base, base[:1]])
    assert e.value.divergence_index == 1
    assert "schedule ends at 1" in str(e.value)


# --------------------------------------------------------------------------
# the seeded divergence mutant
# --------------------------------------------------------------------------


def _mutant_exchange(x, rank):
    """The exchange's all-reduce issued by rank 0 only, after one
    collective every rank issues."""
    g = sim_group("data")
    dist.broadcast(x, 0, group=g)
    if rank == 0:
        dist.all_reduce(x, group=g)
    out = torch.empty(dist.get_world_size(g) * x.numel())
    dist.all_gather_into_tensor(out, x, group=g)


def test_mutant_divergence_is_caught_at_its_first_index():
    def build(pid, world):
        return _mutant_exchange, (torch.ones(4), pid)

    with pytest.raises(LockstepError) as e:
        run_lockstep(build, world=4)
    assert e.value.divergence_index == 1
    msg = str(e.value)
    assert "process 0: #1 all_reduce" in msg
    assert "process 1: #1 all_gather_into_tensor" in msg
    assert len(e.value.schedules) == 4


def test_mutant_passes_when_every_rank_takes_the_branch():
    def build(pid, world):
        return _mutant_exchange, (torch.ones(4), 0)

    schedules = run_lockstep(build, world=4)
    assert all([c.op for c in s] == ["broadcast", "all_reduce",
                                     "all_gather_into_tensor"]
               for s in schedules)


# --------------------------------------------------------------------------
# the shipped exchanges
# --------------------------------------------------------------------------

def _exchange_schedule(world):
    """The 1-bit exchange over 'data' at ``world`` as the JAX package's
    plan lays it out (``ops.comm_compress.make_plan``: 1,000 parameters
    padded in 64-wide buckets, ``nb`` buckets a segment, two chunks):
    per chunk the sign planes (int32, 64 / 32 words a bucket) and the
    scales go out by all-to-all, then the owner's segment comes back by
    all-gather — the JAX programs' ``all_to_all`` / ``all_gather``
    schedule in torch's names."""
    plan = jax_make_plan(1000, world=world, mode="sign_ef", bucket_size=64,
                         chunks=2)
    nbc = -(-plan.nb // 2)
    a2a = [("all_to_all_single", "data", (world, nbc, 2), "int32"),
           ("all_to_all_single", "data", (world, nbc), "float32")]
    gather = [("all_gather", "data", (nbc, 2), "int32"),
              ("all_gather", "data", (nbc,), "float32")]
    return a2a * 2 + gather * 2


def _port_schedule(program, world):
    """Rank 1's schedule of the port's program (on a mesh, data 0 local
    1), as (op, axis, shape, dtype)."""
    if program == "hier_exchange":
        h, n = map(int, world.split("x"))
        s = spmd.run_lockstep_mesh(spmd._hier_program(h, n, "cpu"),
                                   {"data": h, "local": n})[1]
    else:
        s = spmd.run_lockstep(
            spmd.SHIPPED_PROGRAMS[program](world, "cpu"), world)[1]
    return [(c.op, c.axis, c.shape, c.dtype.replace("torch.", ""))
            for c in s]


def test_every_shipped_exchange_holds_lockstep():
    report = verify_shipped(device="cpu")
    assert [(r["program"], r["world"]) for r in report] == [
        (p, w) for p in ("dp_exchange", "fsdp_exchange",
                         "remesh_fold_regrow") for w in (2, 4, 8)] + [
        ("hier_exchange", m) for m in ("2x2", "2x4", "4x2")]
    assert all(r["ok"] for r in report)
    for r in report:
        got = _port_schedule(r["program"], r["world"])
        assert len(got) == r["n_collectives"]
        if r["program"] == "hier_exchange":
            # the in-host mean (JAX's pmean over 'local'), then the
            # exchange over the hosts
            hosts, local = map(int, r["world"].split("x"))
            assert got[0] == ("all_reduce", "local", (1000,), "float32")
            assert got[1:] == _exchange_schedule(hosts)
        else:
            assert got == _exchange_schedule(r["world"]), r


def test_the_remesh_program_refuses_a_remesh_that_replaced_nothing(
        monkeypatch):
    from distributed_mnist_bnns_tpu_torch.parallel import remesh

    monkeypatch.setattr(remesh, "remesh_compress_state",
                        lambda state, plan: (state, 0))
    with pytest.raises(RuntimeError, match="replaced no state"):
        spmd._remesh_program(2, "cpu")
