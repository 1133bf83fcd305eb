"""Port of the runner drills of tests/test_fault.py
(``repro_torch.runtime``): kill the loop mid-run and show that the
restarted run ends with the uninterrupted run's state, bit for bit.

The reference trains a reduced language model, whose training is a later
slice of the port (ROADMAP section 1, item 9); here the step is one
``run_plastic`` step of a 2-chip network, whose crossbar learns under
STDP, with inputs a pure function of the step.  The reshard onto a
smaller mesh (``resume_or(..., shardings=)``) restores a JAX-written
checkpoint onto a 3-rank chip mesh in gloo processes
(tests/torch_dist.py).  The data stream and the prefetcher come with
training (item 9).
"""

import time

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import pulse_comm as pc
from repro_torch.runtime import (FailureInjector, InjectedFailure,
                                 StepTimer, TrainRunner)
from repro_torch.snn import network as net
from repro_torch.snn import synapse as sy

N_CHIPS, N = 2, 16


@pytest.fixture(scope="module")
def plastic():
    comm = pc.PulseCommConfig(n_chips=N_CHIPS, neurons_per_chip=N,
                              n_inputs_per_chip=N, event_capacity=N,
                              bucket_capacity=N, ring_depth=16)
    cfg = net.NetworkConfig(comm=comm)
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    state = {"w": params.crossbar.w,
             "net": net.init_state(cfg, params, device="cpu")}
    return cfg, params, state


def _make_step_fn(cfg, params, seed):
    def step_fn(state, step):
        rng = np.random.default_rng([seed, step])
        ext = torch.from_numpy((1.5 * (rng.random((1, N_CHIPS, N)) < 0.3))
                               .astype(np.float32))
        p = params._replace(crossbar=sy.Crossbar(w=state["w"]))
        p, s, _, _ = net.run_plastic(cfg, p, state["net"], ext,
                                     device="cpu")
        return {"w": p.crossbar.w, "net": s}
    return step_fn


@pytest.mark.parametrize("async_ckpt", [False, True],
                         ids=["sync", "async"])
def test_crash_restart_bitwise_identical(plastic, tmp_path, async_ckpt):
    cfg, params, init_state = plastic
    step_fn = _make_step_fn(cfg, params, seed=0)

    ref = TrainRunner(step_fn=step_fn, ckpt_dir=str(tmp_path / "ref"),
                      ckpt_every=3, async_ckpt=async_ckpt)
    want = ref.run(init_state, 10)

    d = str(tmp_path / "crash")
    r1 = TrainRunner(step_fn=step_fn, ckpt_dir=d, ckpt_every=3,
                     async_ckpt=async_ckpt,
                     injector=FailureInjector(fail_at_step=7))
    with pytest.raises(InjectedFailure):
        r1.run(init_state, 10)
    assert ckpt.latest_step(d) == 5
    r2 = TrainRunner(step_fn=step_fn, ckpt_dir=d, ckpt_every=3,
                     async_ckpt=async_ckpt)
    got = r2.run(init_state, 10)

    assert not torch.equal(want["w"], init_state["w"])   # STDP learnt
    for a, b in zip(ckpt.tree_leaves(want), ckpt.tree_leaves(got)):
        assert torch.equal(a, b)


def test_restart_from_scratch_when_no_checkpoint(plastic, tmp_path):
    cfg, params, init_state = plastic
    runner = TrainRunner(step_fn=_make_step_fn(cfg, params, 0),
                         ckpt_dir=str(tmp_path / "x"), ckpt_every=100,
                         async_ckpt=False)
    state, start = runner.resume_or(init_state)
    assert start == 0 and state is init_state


def test_resume_or_places_the_state_on_the_device_asked_for(plastic,
                                                           tmp_path):
    """``resume_or(..., device=)`` restores each leaf onto ``device`` (the
    port's counterpart of the reference's ``shardings=``)."""
    _, _, init_state = plastic
    d = str(tmp_path / "dev")
    ckpt.save(init_state, d, 4)
    runner = TrainRunner(step_fn=lambda s, t: s, ckpt_dir=d)
    got, start = runner.resume_or(init_state, device="meta")
    assert start == 5
    assert all(x.device.type == "meta" for x in ckpt.tree_leaves(got))
    got, _ = runner.resume_or(ckpt.tree_map(torch.zeros_like, init_state))
    for a, b in zip(ckpt.tree_leaves(init_state), ckpt.tree_leaves(got)):
        assert torch.equal(a, b) and a.device == b.device


def test_straggler_detection():
    timer = StepTimer(threshold=3.0)
    for i in range(5):
        timer.start()
        time.sleep(0.01)
        timer.stop(i)
    timer.start()
    time.sleep(0.2)
    timer.stop(99)
    assert any(s[0] == 99 for s in timer.stragglers)


def test_resume_or_reshards_onto_smaller_mesh(tmp_path):
    """Elastic restart: a checkpoint written by the JAX store (from an
    8-chip mesh in the reference's drill) restores onto a 3-rank chip
    mesh through ``resume_or(..., shardings=)``: same values, ``w``
    sharded 8 rows a rank, ``b`` replicated, and the run resumes after
    the checkpoint's step."""
    jax = pytest.importorskip("jax")
    from repro import checkpoint as jckpt

    import torch_dist

    w = np.arange(96, dtype=np.float32).reshape(24, 4)
    b = np.arange(8, dtype=np.float32)
    jckpt.save({"w": jax.numpy.asarray(w), "b": jax.numpy.asarray(b)},
               str(tmp_path / "ckpt"), 4)
    out = torch_dist.spawn(torch_dist.resume_worker, 3, tmp_path,
                           str(tmp_path / "ckpt"))
    for r, o in enumerate(out):
        assert o["start"] == 5
        gw, gb = o["got"]["w"], o["got"]["b"]
        np.testing.assert_array_equal(gw["full"].numpy(), w)
        np.testing.assert_array_equal(gb["full"].numpy(), b)
        assert tuple(gw["local"].shape) == (8, 4)
        np.testing.assert_array_equal(gw["local"].numpy(), w[8 * r:8 * r + 8])
        assert gw["mesh"] == gb["mesh"] == (3,)
        assert gb["placements"] == ["Replicate()"]
