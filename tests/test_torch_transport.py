"""Port parity, transports (counterpart of tests/test_transport.py): the
local transport's ``all_to_all``, ``put``, ``psum`` and ``chip_index``
against the JAX ``LocalTransport``, and the distributed transport on
``torch.distributed`` in 4 gloo processes on the CPU against the local
one, bitwise:

* the flat exchange at one and at two chips a rank, ``put``, ``psum``,
  ``chip_index``;
* the hierarchical exchanges over ``("pod", "chip")`` (2 x 2) and three
  axes (2 x 1 x 2), equal to the flat one;
* the exchange protocol (``exchange_words_start``: words, link words,
  backlog) over two ranks of two chips (the chip axis of the 2 x 2 mesh,
  each pod its own exchange);
* the routed transport bound to the distributed one
  (``Topology.transport(axis, mesh=)``): the words, ``link_words`` and
  ``link_backlog`` of each rank equal the single-device transport's
  rows, on a torus, a switch tree, degraded, over two chips a rank, and
  a pod over the ``("pod", "chip")`` 2-tuple.

The gloo children are spawned once, by a module-scoped fixture; they
import no JAX (tests/torch_dist.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import transport as jtp  # noqa: E402
from repro_torch.core import topology as tpo  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
import torch_dist  # noqa: E402

PERM = [(0, 2), (3, 1), (1, 3)]      # chip 0 receives nothing


def words(rng, shape, p_valid=0.6):
    """Random wire words (22-bit non-negative ints), sentinel -1 where
    not valid."""
    w = rng.integers(0, 1 << 22, shape).astype(np.int32)
    return np.where(rng.random(shape) < p_valid, w, -1).astype(np.int32)


def same(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


# ---------------------------------------------------------------------------
# The local transport against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["all_to_all", "put", "psum", "chip_index"])
def test_local_transport_matches_jax(op):
    x = words(np.random.default_rng(0), (4, 4, 3))
    got, want = tp.LocalTransport(4), jtp.LocalTransport(4)
    args = {"all_to_all": (), "put": (PERM,), "psum": (),
            "chip_index": None}[op]
    if args is None:
        same(want.chip_index(), got.chip_index())
        return
    same(getattr(want, op)(jnp.asarray(x), *args),
         getattr(got, op)(torch.as_tensor(x), *args), op)


def test_exchange_matrix_matches_jax():
    rng = np.random.default_rng(1)
    dest = rng.integers(-3, 7, (5, 32)).astype(np.int32)
    valid = rng.random((5, 32)) < 0.7
    want = jax.vmap(lambda d, v: jtp.exchange_matrix(d, v, 4))(
        jnp.asarray(dest), jnp.asarray(valid))
    same(want, tp.exchange_matrix(torch.as_tensor(dest),
                                  torch.as_tensor(valid), 4))


# ---------------------------------------------------------------------------
# The distributed transport, in 4 gloo processes
# ---------------------------------------------------------------------------

def _mask_dead(x, healthy, n):
    """Sentinel out every slab to or from a dead chip (the fabric culls
    that traffic before the exchange)."""
    if healthy is None:
        return x
    alive = np.zeros(n, bool)
    alive[list(healthy)] = True
    pair = alive[:, None] & alive[None, :]
    return np.where(pair.reshape(pair.shape + (1,) * (x.ndim - 2)), x, -1)


ROUTED = {
    "torus": (tpo.torus2d(2, 2, link_latency=1), None, (), "flat"),
    "tree": (tpo.switch_tree(2, 2, link_latency=1, trunk_latency=2,
                             link_bandwidth=3), None, (), "flat"),
    "torus-degraded": (tpo.torus2d(2, 2, link_latency=1), (0, 1, 2),
                       ((0, 0),), "flat"),
    "torus-2-a-rank": (tpo.torus2d(2, 2, link_latency=1), None, (), "sub"),
    "tree-2-a-rank": (tpo.switch_tree(2, 2, link_bandwidth=2), None, (),
                      "sub"),
    "pod-2-tuple": (tpo.pod(tpo.ring(2), 2, link_latency=1), None, (),
                    "pod2"),
}


@pytest.fixture(scope="module")
def dist4(tmp_path_factory):
    rng = np.random.default_rng(2)
    data = dict(x4=words(rng, (4, 4, 3)), x8=words(rng, (8, 8, 2, 3)),
                perm=PERM, routed={})
    for key, (topo, healthy, dead_links, where) in ROUTED.items():
        x = _mask_dead(words(rng, (4, 4, 2, 2, 3)), healthy, 4)
        data["routed"][key] = (topo, healthy, dead_links, where, x)
    out = torch_dist.spawn(torch_dist.transport_worker, 4,
                           tmp_path_factory.mktemp("transport"), data)
    return data, out


def _gather(out, key, ranks=range(4)):
    return torch.cat([out[r][key] for r in ranks])


@pytest.mark.parametrize("n", [4, 8], ids=["one-chip-a-rank",
                                           "two-chips-a-rank"])
def test_all_to_all_equals_the_swap(dist4, n):
    data, out = dist4
    x = torch.as_tensor(data[f"x{n}"])
    same(_gather(out, f"a2a{n}"), tp.LocalTransport(n).all_to_all(x))
    same(_gather(out, f"chip_index{n}"), np.arange(n))


@pytest.mark.parametrize("name", ["pod", "three"])
def test_hierarchical_exchange_equals_the_flat_one(dist4, name):
    """``("pod", "chip")`` on 2 x 2 and three axes on 2 x 1 x 2: the
    stages run innermost first, and the result is bitwise the flat
    exchange's (and the swap's)."""
    data, out = dist4
    same(_gather(out, f"a2a8_{name}"), _gather(out, "a2a8"))
    same(_gather(out, f"chip_index8_{name}"), np.arange(8))
    same(_gather(out, f"psum8_{name}"), _gather(out, "psum8"))


def test_put_and_psum_equal_the_local_transport(dist4):
    data, out = dist4
    x = torch.as_tensor(data["x4"])
    local = tp.LocalTransport(4)
    same(_gather(out, "put4"), local.put(x, PERM))
    same(_gather(out, "psum4"), local.psum(x))
    same(_gather(out, "psum8"), tp.LocalTransport(8).psum(
        torch.as_tensor(data["x8"])))


@pytest.mark.parametrize("pod", [0, 1])
def test_two_ranks_of_two_chips_equal_the_local_transport(dist4, pod):
    """The exchange protocol over the chip axis of the 2 x 2 mesh: each
    pod exchanges its own 4 chips, two on each of its ranks; a rank that
    used local chip ids would count chip 2 as chip 0."""
    data, out = dist4
    x = torch_dist.shifted(torch.as_tensor(data["x4"]), 100 * pod)
    ranks = (2 * pod, 2 * pod + 1)
    want = tp.LocalTransport(4).exchange_words_start(x)
    for i, name in enumerate(("words", "link_words", "link_backlog")):
        same(torch.cat([out[r]["start_sub"][i] for r in ranks]), want[i],
             name)
    assert int(want[1].sum()) > 0
    same(torch.cat([out[r]["put_sub"] for r in ranks]),
         tp.LocalTransport(4).put(x, PERM))


@pytest.mark.parametrize("key", list(ROUTED))
def test_routed_shard_transport_equals_the_single_device_rows(dist4, key):
    data, out = dist4
    topo, healthy, dead_links, where, x = data["routed"][key]
    local = tpo.RoutedTransport(topology=topo).with_health(healthy,
                                                           dead_links)
    pods = (0, 1) if where == "sub" else (None,)
    for pod in pods:
        xp = torch.as_tensor(x)
        ranks = range(4)
        if pod is not None:
            xp = torch_dist.shifted(xp, pod)
            ranks = (2 * pod, 2 * pod + 1)
        want = local.exchange_words(xp)
        for i, name in enumerate(("words", "link_words", "link_backlog")):
            same(torch.cat([out[r]["routed"][key][i] for r in ranks]),
                 want[i], f"{key} {name}")
        assert int(want[1].sum()) > 0


def test_distributed_transport_guards(dist4):
    """An uneven split, ``put`` over an axis tuple and a tuple axis on a
    non-pod topology are refused, as the reference refuses the last
    two."""
    _, out = dist4
    for r in range(4):
        errors = out[r]["errors"]
        assert errors["uneven"].startswith("ValueError"), errors
        assert "do not split evenly" in errors["uneven"]
        assert errors["put_tuple"].startswith("ValueError"), errors
        assert errors["tree_tuple"].startswith("TypeError"), errors


def test_mesh_builders(dist4):
    """``launch/mesh.py`` over the 4-rank world: the chip mesh (all ranks,
    or the first 3), the host mesh ("data", "model") = (2, 2); the
    production mesh (256 ranks) and a chip mesh past the world raise, as
    the reference does."""
    _, out = dist4
    for r in range(4):
        m = out[r]["meshes"]
        assert m["chip"] == ((4,), ("chip",))
        assert m["chip3"] == (3,)
        assert m["host"] == ((2, 2), ("data", "model"))
        assert m["production"].startswith("RuntimeError: need 256")
        assert m["too_big"].startswith("RuntimeError: need 5")


def test_distributed_transport_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tp.DistributedTransport(mesh=None, axis="chip", n_chips=4)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpo.torus2d(2, 2).transport("chip", mesh=None)
