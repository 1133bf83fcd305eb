"""Port parity, network: ``repro_torch.snn.network.run`` against the JAX
``repro.snn.network.run`` from the same weights and state, carried across
with ``repro_torch.convert``, on the CPU.

Spike trains are equal and integer stats bitwise.  Voltages agree within
``atol=1e-5``: the crossbar sums are exact (the random nets use weights
on a dyadic grid and 0/1 inputs, so every partial sum is representable in
f32), but ``exp`` (the LIF decay, the AdEx exponential) is computed by
PyTorch and by XLA with different implementations, which may differ in
the last bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import routing as jrt  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import demo  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.snn import network as net  # noqa: E402

ATOL = 1e-5


def _run_both(jcfg, cfg, jparams, ext):
    jstate = jnet.init_state(jcfg, jparams)
    jfinal, jrec = jax.jit(lambda p, s, e: jnet.run(jcfg, p, s, e))(
        jparams, jstate, jnp.asarray(ext))
    params = convert.params_from_jax(jparams, device="cpu")
    state = convert.state_from_jax(jstate, device="cpu")
    final, rec = net.run(cfg, params, state, ext, device="cpu")
    return (jfinal, jrec), (final, rec)


def _check(jrec, rec, jfinal, final):
    np.testing.assert_array_equal(np.asarray(jrec.spikes), rec.spikes.numpy())
    np.testing.assert_allclose(rec.voltage.numpy(), np.asarray(jrec.voltage),
                               rtol=0, atol=ATOL)
    for f in jrec.stats._fields:
        w, g = np.asarray(getattr(jrec.stats, f)), getattr(rec.stats, f)
        if f == "utilization":
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-7)
        else:
            np.testing.assert_array_equal(w, g.numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jfinal.ring.ring),
                                  final.ring.ring.numpy())
    np.testing.assert_array_equal(np.asarray(jfinal.ring.now),
                                  final.ring.now.numpy())
    assert int(jfinal.t) == int(final.t)


def test_feedforward_demo_matches_jax():
    n = demo.N
    comm_kw = dict(n_chips=2, neurons_per_chip=n, n_inputs_per_chip=n,
                   event_capacity=n, bucket_capacity=n, ring_depth=8)
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**comm_kw),
                              neuron_model="lif")
    table = jrt.feedforward_table(n, src_chip=0, dst_chip=1,
                                  delay=demo.DELAY)
    jparams = jnet.init_params(jax.random.PRNGKey(0), jcfg, table=table)
    w = np.zeros((2, n, n), np.float32)
    w[0] = 1.5 * np.eye(n)
    w[1] = 0.6 * np.eye(n)
    jparams = jparams._replace(
        crossbar=jparams.crossbar._replace(w=jnp.asarray(w)))
    cfg, _, _, ext = demo.setup("cpu")
    (jfinal, jrec), (final, rec) = _run_both(jcfg, cfg, jparams, ext)
    _check(jrec, rec, jfinal, final)
    src_t = np.nonzero(rec.spikes.numpy()[:, 0, 0])[0]
    dst_t = np.nonzero(rec.spikes.numpy()[:, 1, 0])[0]
    assert np.diff(dst_t).mean() == 2 * np.diff(src_t).mean()
    # the port's own demo builds the same network
    _, params, _, _ = demo.setup("cpu")
    np.testing.assert_array_equal(params.crossbar.w.numpy(), w)


def test_demo_main_reports_isi_doubling(capsys):
    src_t, dst_t = demo.main("cpu")
    out = capsys.readouterr().out
    assert out.rstrip().endswith("ISI doubling REPRODUCED")
    assert src_t[:3] == [0, 4, 8] and dst_t[:2] == [6, 14]


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("model", ["lif", "adex"])
def test_random_network_matches_jax(model, b):
    """LIF: fan-out 1, full mode with the rate-limited merge (fused
    inject, rate drain); AdEx: fan-out 2, simplified (bucket pack,
    passthrough drain)."""
    comm_kw = dict(n_chips=4, neurons_per_chip=32, n_inputs_per_chip=32,
                   event_capacity=32, bucket_capacity=8, ring_depth=16,
                   superstep=b)
    if model == "lif":
        comm_kw.update(fanout=1, mode="full", buckets_per_chip=2,
                       merge_rate=3, merge_depth=8)
    else:
        comm_kw.update(fanout=2, mode="simplified")
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**comm_kw),
                              neuron_model=model)
    cfg = net.NetworkConfig(comm=pc.PulseCommConfig(**comm_kw),
                            neuron_model=model)
    jparams = jnet.init_params(jax.random.PRNGKey(b), jcfg)
    rng = np.random.default_rng(b)
    w = np.round(rng.normal(0, 0.5, (4, 32, 32)) * 16) / 16   # dyadic
    jparams = jparams._replace(crossbar=jparams.crossbar._replace(
        w=jnp.asarray(w, jnp.float32)))
    ext = (rng.random((16, 4, 32)) < 0.2).astype(np.float32)
    (jfinal, jrec), (final, rec) = _run_both(jcfg, cfg, jparams, ext)
    _check(jrec, rec, jfinal, final)
    assert int(rec.stats.sent.sum()) > 0
    if model == "lif":
        np.testing.assert_array_equal(np.asarray(jfinal.merge.words),
                                      final.merge.words.numpy())


def test_step_equals_a_one_step_run():
    cfg, params, state, ext = demo.setup("cpu")
    s1, rec1 = net.step(cfg, params, state, ext[0], device="cpu")
    s2, rec2 = net.run(cfg, params, state, ext[:1], device="cpu")
    assert torch.equal(rec1.spikes, rec2.spikes[0])
    assert torch.equal(s1.ring.ring, s2.ring.ring)


def test_run_length_must_be_a_multiple_of_the_superstep():
    comm = pc.PulseCommConfig(n_chips=2, neurons_per_chip=8,
                              n_inputs_per_chip=8, superstep=4)
    cfg = net.NetworkConfig(comm=comm)
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    state = net.init_state(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        net.run(cfg, params, state, np.zeros((6, 2, 8), np.float32),
                device="cpu")
    with pytest.raises(ValueError, match="superstep"):
        net.step(cfg, params, state, np.zeros((2, 8), np.float32),
                 device="cpu")
