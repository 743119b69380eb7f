"""The port's device mesh (`parallel.mesh`) and mesh serving
(`SessionServer(mesh=)`, `make_session_server(mesh=)`) on the CPU:

- `tp_spec` equals JAX's on a list of shapes (ties to the later axis,
  `min_size`, an n_mp that divides no axis, vectors, n_mp 1);
- `make_mesh` layouts (a repeated device, n_dp / n_mp, too few devices, no
  card without devices=), `shard_batch` and `replicate_to_mesh`;
- `shard_by_slots` with 128 slots at a width of 128: JAX's heuristic cuts
  the width, the exact `slot_axes` the slots;
- `SessionServer(mesh=)` over [cpu] * 2 for a small flagship-layout SkiM
  TSE and a small DPCRN, over a script of attaches, a detach and a
  re-attach on either replica: within 1e-6 of max|ref| of the one-device
  server (the CPU's float32 products round apart at another row count,
  ~1e-7; the card's phase 8b says where it is bit-equal), and
  within 2e-5 of max|ref| of JAX's `SessionServer(mesh=)` on two CPU
  devices (float32; the two float computations differ by ~1e-7);
- pipelined and pcm16 under the mesh as without it; a reset touches only
  its replica's rows;
- `make_session_server(mesh=, fused=True)` and the other kernel routes
  raise JAX's ValueError; a mesh over process ranks and a slot count the
  dp size does not divide raise too.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from puresound_tpu.parallel.mesh import make_mesh as j_make_mesh
from puresound_tpu.parallel.mesh import shard_by_slots as j_shard_by_slots
from puresound_tpu.parallel.mesh import tp_spec as j_tp_spec
from puresound_tpu_torch.parallel import (make_mesh, replicate_to_mesh, shard_batch,
                                          shard_by_slots, tp_spec)
from puresound_tpu_torch.parallel.mesh import Mesh
from puresound_tpu_torch.streaming.deploy import make_session_server
from puresound_tpu_torch.streaming.server import infer_slot_axes
from test_torch_serving_transport import E, _models

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def ring_hub():
    from puresound_tpu_torch.src import native

    return native.load()


# ------------------------------------------------------------------ tp_spec
@pytest.mark.parametrize("shape,n_mp,min_size", [
    ((128, 64), 2, 64), ((64, 128), 2, 64), ((128, 128), 4, 64), ((64, 64, 3), 2, 8),
    ((8, 8), 2, 64), ((96, 40), 3, 8), ((7, 9), 2, 1), ((256,), 2, 8),
    ((512, 256, 1), 1, 8), ((24, 48, 48), 4, 8), ((30, 20), 4, 8), ((16, 32, 16), 2, 16)])
def test_tp_spec_equals_jax(shape, n_mp, min_size):
    want = tuple(j_tp_spec(shape, n_mp, min_size))
    assert tp_spec(shape, n_mp, min_size) == want
    assert (want == ()) == (j_tp_spec(shape, n_mp, min_size) == P())


# ---------------------------------------------------------------- make_mesh
def test_make_mesh_layouts():
    devs = [CPU, torch.device("meta"), CPU, torch.device("meta")]
    m = make_mesh(devices=devs)
    assert m.shape == {"dp": 4, "mp": 1} and m.size == 4 and not m.over_ranks
    m = make_mesh(n_mp=2, devices=devs)
    assert m.shape == {"dp": 2, "mp": 2}
    assert m.along("dp") == [CPU, CPU] and m.along("mp") == [CPU, torch.device("meta")]
    assert m.along() == devs
    assert make_mesh(1, 1, devices=devs).shape == {"dp": 1, "mp": 1}
    assert make_mesh(n_dp=3, devices=["cpu"] * 5).along() == [CPU] * 3
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_mesh(n_dp=3, n_mp=2, devices=devs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="sees none"):
            make_mesh()


def test_shard_batch_and_replicate(rng):
    x = torch.from_numpy(rng.standard_normal((6, 5)))
    parts = shard_batch(make_mesh(devices=[CPU] * 3), {"x": x, "s": 2.0, "e": None})
    assert len(parts) == 3 and all(p["s"] == 2.0 and p["e"] is None for p in parts)
    assert torch.equal(torch.cat([p["x"] for p in parts]), x)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(make_mesh(devices=[CPU] * 4), {"x": x})
    copies = replicate_to_mesh(make_mesh(devices=[CPU] * 2), {"a": x, "n": 3})
    assert len(copies) == 2 and all(torch.equal(c["a"], x) and c["n"] == 3 for c in copies)


# ------------------------------------------------------------ shard_by_slots
def test_shard_by_slots_exact_axes_where_jax_heuristic_cuts_the_width(rng):
    """128 slots at C = 128: a [D, B, H] carry and a [B, C] row and a
    [C, B] transposed leaf, a shared clock. The heuristic (JAX's, and the
    port's without slot_axes) takes the first axis of size 128, which for
    the [C, B] leaf is the width."""
    n = 128

    def init(b):
        return {"h": torch.zeros(2, b, 16), "row": torch.zeros(b, 128),
                "t": torch.arange(128 * b, dtype=torch.float32).reshape(128, b),
                "fold": torch.zeros(1, b * 3, 4), "clock": torch.zeros(())}

    state = init(n)
    axes = infer_slot_axes(init)
    assert axes == {"h": 1, "row": 0, "t": 1, "fold": 1, "clock": -1}
    mesh = make_mesh(devices=[CPU] * 2)
    exact = shard_by_slots(mesh, state, n, slot_axes=axes)
    guess = shard_by_slots(mesh, state, n)
    assert exact[0]["t"].shape == (128, 64) and guess[0]["t"].shape == (64, 128)
    assert torch.equal(torch.cat([p["t"] for p in exact], 1), state["t"])
    assert exact[1]["fold"].shape == (1, 192, 4) and exact[1]["clock"].shape == ()
    assert exact[0]["h"].shape == (2, 64, 16) and exact[0]["row"].shape == (64, 128)
    # JAX's heuristic shards the same (wrong) axis of the transposed leaf
    jmesh = j_make_mesh(n_dp=2, devices=jax.devices()[:2])
    j = j_shard_by_slots(jmesh, {"t": state["t"].numpy()}, n)
    assert j["t"].sharding.spec == P("dp", None)


# ---------------------------------------------------------------- serving
def _script(bundle, kind, rng, n=4):
    """Sessions a, b, c attach (slots 0, 1, 2: replicas 0, 0, 1 of a dp = 2
    mesh), two ticks; b detaches and d takes slot 1; two ticks; e attaches
    on slot 3 (replica 1); two ticks. Returns {session: its output}."""
    server, chunk = bundle.server, bundle.chunk_samples
    audio = {k: (0.3 * rng.standard_normal(8 * chunk)).astype(np.float32) for k in "abcde"}
    enroll = {k: (0.3 * rng.standard_normal(400)).astype(np.float32) for k in "abcde"}
    fed, sids = dict.fromkeys(audio, 0), {}
    got = {k: [] for k in audio}

    def attach(k):
        sids[k] = server.attach(enroll=enroll[k]) if kind == "tse" else server.attach()

    def tick():
        for k, sid in sids.items():
            server.hub.push_input(sid, audio[k][fed[k] * chunk:(fed[k] + 1) * chunk])
            fed[k] += 1
        server.tick()
        for k, sid in sids.items():
            avail = server.hub.output_available(sid)
            if avail:
                got[k].append(server.hub.pop_output(sid, avail))

    for k in "abc":
        attach(k)
    assert [sids[k] for k in "abc"] == [0, 1, 2]
    tick(), tick()
    server.detach(sids.pop("b"))
    attach("d")
    assert sids["d"] == 1
    tick(), tick()
    attach("e")
    assert sids["e"] == 3
    tick(), tick()
    server.flush()
    for k, sid in sids.items():
        avail = server.hub.output_available(sid)
        if avail:
            got[k].append(server.hub.pop_output(sid, avail))
    return {k: np.concatenate(v) for k, v in got.items() if v}


def _serve(pm, kind, mesh=None, **kw):
    extra = dict(enroll_len=400) if kind == "tse" else {}
    return make_session_server(pm, None, n_slots=4, chunk_ms=10.0, lockstep=True,
                               mesh=mesh, **extra, **kw)


@pytest.mark.parametrize("kind", ["tse", "ns"])
def test_mesh_server_equals_one_device_and_jax_mesh_server(rng, ring_hub, kind):
    from puresound_tpu.streaming.deploy import make_session_server as j_make

    jm, v, pm = _models(kind, rng)
    mesh = make_mesh(n_dp=2, devices=[CPU] * 2)
    meshed = _serve(pm, kind, mesh)
    server = meshed.server
    assert len(server._state) == 2 and server.mesh is mesh
    want = _script(_serve(pm, kind), kind, np.random.default_rng(5))
    got = _script(meshed, kind, np.random.default_rng(5))
    assert set(got) == set(want) == set("abcde")
    for k in want:
        _close(got[k], want[k], 1e-6, k)
    # against JAX's SessionServer(mesh=) on two CPU devices
    extra = dict(enroll_len=400) if kind == "tse" else {}
    jb = j_make(jm, v, n_slots=4, chunk_ms=10.0, lockstep=True,
                mesh=j_make_mesh(n_dp=2, devices=jax.devices()[:2]), **extra)
    jgot = _script(jb, kind, np.random.default_rng(5))
    for k in want:
        _close(got[k], jgot[k], 2e-5, k)


def _close(got, want, rel, what, extra=0.0):
    peak = np.abs(want).max()
    assert peak > 1e-3 and got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=rel * peak + extra, rtol=0, err_msg=what)


@pytest.mark.parametrize("pcm16", [False, True])
def test_mesh_server_pipelined_and_pcm16(rng, ring_hub, pcm16):
    _, _, pm = _models("tse", rng)
    mesh = make_mesh(devices=[CPU] * 2)
    plain = _script(_serve(pm, "tse", pcm16=pcm16), "tse", np.random.default_rng(3))
    meshed = _script(_serve(pm, "tse", mesh, pcm16=pcm16), "tse", np.random.default_rng(3))
    piped = _script(_serve(pm, "tse", mesh, pcm16=pcm16, pipelined=True), "tse",
                    np.random.default_rng(3))
    for k in plain:
        # pcm16: one int16 step apart where the float outputs round apart
        _close(meshed[k], plain[k], 1e-6, k, extra=1.0 / 8192 if pcm16 else 0.0)
        np.testing.assert_array_equal(piped[k], meshed[k][:len(piped[k])], err_msg=k)
    # b detached with nothing in flight under lockstep: the pipelined server
    # lost only what the detach dropped
    assert sum(map(len, piped.values())) >= sum(map(len, plain.values())) - 4 * 160


def test_reset_and_attach_reach_their_replica(rng, ring_hub):
    _, _, pm = _models("tse", rng)
    bundle = _serve(pm, "tse", make_mesh(devices=[CPU] * 2))
    server, chunk = bundle.server, bundle.chunk_samples
    sids = [server.attach(dvec=np.random.default_rng(i).standard_normal(E)) for i in range(4)]
    for _ in range(2):
        for sid in sids:
            server.hub.push_input(sid, (0.3 * rng.standard_normal(chunk)).astype(np.float32))
        server.tick()
    # the d-vector rows live on their replica
    for i in range(2):
        np.testing.assert_array_equal(server._dvec_dev[i].numpy(), server._dvec[2 * i:2 * i + 2])
    before = [{k: t.clone() for k, t in _tensors(s)} for s in server._state]
    server.detach(sids[3])
    sid = server.attach(dvec=np.ones(E))
    assert sid == 3
    np.testing.assert_array_equal(server._dvec_dev[0].numpy(), server._dvec[:2])
    # the reset runs at the slot's first ready tick, on replica 1's row 1 only
    state0 = server._state[0]
    server._state[1] = server._reset(server._state[1], server._fresh[1],
                                     np.array([False, True]), False)
    assert server._state[0] is state0
    after = dict(_tensors(server._state[1]))
    fresh = dict(_tensors(server._fresh[1]))
    axes = infer_slot_axes(lambda n: bundle.engine.init_state(n))
    for (k, t), (_, ax) in zip(_tensors(server._state[1]), _tensors_axes(axes)):
        if ax < 0:
            assert torch.equal(t, before[1][k])
            continue
        assert torch.equal(t.select(ax, 0), before[1][k].select(ax, 0)), k
        assert torch.equal(t.select(ax, 1), fresh[k].select(ax, 1)), k
    assert set(after) == set(before[1])


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _tensors(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _tensors(v, f"{prefix}{i}/")]
    return [(prefix, tree)] if isinstance(tree, torch.Tensor) else []


def _tensors_axes(axes, prefix=""):
    if isinstance(axes, dict):
        return [x for k, v in axes.items() for x in _tensors_axes(v, f"{prefix}{k}/")]
    if isinstance(axes, (list, tuple)):
        return [x for i, v in enumerate(axes) for x in _tensors_axes(v, f"{prefix}{i}/")]
    return [(prefix, axes)]


@pytest.mark.parametrize("route", ["fused", "dp_kernel", "attn_kernel", "mk_kernel"])
def test_mesh_refuses_the_kernel_routes_as_jax(rng, route):
    from puresound_tpu.streaming.deploy import make_session_server as j_make

    kind = "tse" if route == "fused" else "ns"
    jm, v, pm = _models(kind, rng)
    with pytest.raises(ValueError, match="stock step only") as mine:
        make_session_server(pm, None, 4, mesh=make_mesh(devices=[CPU] * 2), **{route: True})
    with pytest.raises(ValueError, match="stock step only") as jax_s:
        j_make(jm, v, 4, mesh=j_make_mesh(n_dp=2, devices=jax.devices()[:2]),
               **{route: True})
    assert str(mine.value) == str(jax_s.value)


def test_mesh_server_refusals(rng, ring_hub):
    _, _, pm = _models("ns", rng)
    with pytest.raises(ValueError, match="not divisible by the dp mesh axis"):
        make_session_server(pm, None, 3, mesh=make_mesh(devices=[CPU] * 2))
    with pytest.raises(ValueError, match="single-process"):
        make_session_server(pm, None, 4, mesh=Mesh(range(2), 2, 1, over_ranks=True))
