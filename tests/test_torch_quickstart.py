"""``repro_torch.quickstart`` on the CPU against the JAX package's
quickstart network (``examples/quickstart.py``): the same LUT (through
``convert.table_from_jax``), weights and input, both networks (plain, and
under ``FlowControlConfig(capacity=2, drain_rate=1)``).  Totals of
spikes, sent, overflow, expired and stalled must be equal.

The JAX quickstart's crossbar is put on a 1/64 grid in both runs, so
every crossbar sum is exact in any order of summation (PyTorch's and
XLA's float32 sums may otherwise differ in the last bit at a
threshold).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import routing as jrt  # noqa: E402
from repro.core.fabric import FlowControlConfig  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import convert, quickstart  # noqa: E402

KEYS = ("spikes", "sent", "overflow", "expired", "stalled")


def _jax_quickstart():
    """The JAX quickstart's config, params (crossbar on the dyadic grid)
    and input."""
    comm = jpc.PulseCommConfig(
        n_chips=4, neurons_per_chip=64, n_inputs_per_chip=64,
        event_capacity=64, bucket_capacity=16, ring_depth=16)
    cfg = jnet.NetworkConfig(comm=comm, neuron_model="lif")
    key = jax.random.PRNGKey(0)
    table = jrt.random_table(key, 64, 4, fanout=2, max_delay=6)
    params = jnet.init_params(key, cfg, table=table, weight_scale=0.4)
    params = params._replace(crossbar=params.crossbar._replace(
        w=jnp.round(params.crossbar.w * 64) / 64))
    ext = (np.random.default_rng(0).random((100, 4, 64)) < 0.05).astype(
        np.float32)
    return comm, params, ext


def test_quickstart_totals_match_jax(capsys):
    comm, jparams, ext = _jax_quickstart()
    want = []
    for flow in (None, FlowControlConfig(capacity=2, drain_rate=1)):
        cfg = jnet.NetworkConfig(comm=comm, neuron_model="lif", flow=flow)
        _, rec = jax.jit(lambda p, s, e: jnet.run(cfg, p, s, e))(
            jparams, jnet.init_state(cfg, jparams), jnp.asarray(ext))
        want.append({k: int(np.asarray(getattr(rec.stats, k)).sum())
                     for k in KEYS[1:]}
                    | {"spikes": int(np.asarray(rec.spikes).sum())})
    params = convert.params_from_jax(jparams, device="cpu")
    table = convert.table_from_jax(jparams.table, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(table, params.table))
    got = quickstart.main("cpu", params=params, ext=ext)
    for w, g in zip(want, got):
        assert {k: g[k] for k in KEYS} == w
    assert got[0]["sent"] > 0 and got[1]["stalled"] > 0
    assert "events stalled at the source" in capsys.readouterr().out


def test_quickstart_defaults_run_on_the_cpu():
    plain, fc = quickstart.main("cpu")
    assert plain["spikes"] > 0 and plain["stalled"] == 0
    assert fc["stalled"] > 0 and fc["sent"] > 0
