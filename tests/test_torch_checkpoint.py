"""Checkpoints of the port's engine state, and the reference's loaded.

``repro_torch.checkpoint`` writes the reference's format: one ``.npz``
keyed by tree path with the reference's key names and a CRC32 a leaf.
Tolerances: a round-trip is bitwise, and the rounds after it bitwise
the uninterrupted run's; a run resumed in the port from the reference's
checkpoint holds the engine tests' tolerances against the reference's
own resumed rounds (cohorts, channel states and the buffer's due and
tau bitwise, params and buffer vectors rtol 1e-4 / atol 1e-5).
"""
import os

import jax
import numpy as np
import pytest
from tests._torch_ref_caches import reference_program_caches  # noqa: F401
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.core.async_agg import AsyncConfig as JAsync
from repro.core.selection import SelectionConfig as JSel
from repro.core.server import FederatedServer as JServer
from repro.core.server import FLConfig as JConfig
from repro.core.tra import TRAConfig as JTRA
from repro.data.synthetic import generate_synthetic as j_generate
from repro.netsim import NetSimConfig as JNetSim
from repro.network.trace import ClientNetworks as JNets
from repro_torch.checkpoint import (CheckpointCorruptionError,
                                    load_checkpoint, save_checkpoint)
from repro_torch.convert import params_from_jax
from repro_torch.core.async_agg import EMPTY_DUE
from repro_torch.core.async_agg import AsyncConfig as TAsync
from repro_torch.core.selection import SelectionConfig as TSel
from repro_torch.core.server import FederatedServer as TServer
from repro_torch.core.server import FLConfig as TConfig
from repro_torch.core.tra import TRAConfig as TTRA
from repro_torch.data.synthetic import generate_synthetic as t_generate
from repro_torch.netsim.config import NetSimConfig as TNetSim
from repro_torch.network.trace import ClientNetworks as TNets

N_CLIENTS = 20


@pytest.fixture(scope="module")
def small():
    speeds = np.linspace(0.5, 20.0, N_CLIENTS)
    loss = np.full(N_CLIENTS, 0.05)
    return (j_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5), JNets(speeds, loss),
            t_generate(np.random.default_rng(0), n_clients=N_CLIENTS,
                       alpha=0.5, beta=0.5), TNets(speeds, loss))


def _cfg(pkg):
    """tests/test_async.py's checkpoint case: async with K = 6, EF, the
    staleness_aware policy, a 0.1 s deadline and the AR(1) walk, so the
    buffer, the lateness memory and the bandwidth levels all carry."""
    Cfg, Tra, Net, Srv, Sel = (
        (JConfig, JTRA, JNetSim, JAsync, JSel) if pkg == "j"
        else (TConfig, TTRA, TNetSim, TAsync, TSel))
    return Cfg(algo="fedavg", n_rounds=4, clients_per_round=8, local_steps=2,
               batch_size=8, eval_every=10 ** 6, seed=0, error_feedback=True,
               sel=Sel(policy="staleness_aware"),
               tra=Tra(enabled=True, loss_rate=0.3),
               netsim=Net(channel="gilbert_elliott", burst_len=8.0,
                          bw_ar1=True, deadline=True, deadline_s=0.1),
               srv=Srv(mode="async", buffer_k=6))


def _leaves(state):
    out = {}
    for name in state._fields:
        v = getattr(state, name)
        if isinstance(v, dict):
            out.update({f"{name}/{k}": x for k, x in v.items()})
        elif isinstance(v, tuple):
            out.update({f"{name}/{f}": getattr(v, f) for f in v._fields})
        else:
            out[name] = v
    return out


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k].numpy(), lb[k].numpy(),
                                      err_msg=k)


def test_roundtrip_with_live_buffer_is_bitwise(small, tmp_path):
    """2 rounds, save, load, 2 more: bitwise the uninterrupted 4 rounds,
    with live buffer entries in flight at the boundary; the file holds
    the reference's key names."""
    _, _, tdata, tnets = small
    srv = TServer(_cfg("t"), tdata, tnets, device="cpu")
    eng = srv.engine
    mid, _ = eng.run_block(eng.init_state(srv.params), 0, 2)
    assert (mid.buf.due < EMPTY_DUE).any()
    path = save_checkpoint(str(tmp_path / "ck"), mid, step=2)
    with np.load(path + ".npz") as f:
        keys = set(f.files)
    for k in (".params/w1", ".buf/.due", ".buf/.vec", ".net/.channel",
              ".net/.logbw", ".stale_mem", ".ef_mem", "__crc__/.buf/.vec",
              "__step__"):
        assert k in keys, k
    restored, step = load_checkpoint(path, mid)
    assert step == 2
    _assert_states_equal(restored, mid)
    full, lf = eng.run_block(mid, 2, 2)
    resumed, lr = eng.run_block(restored, 2, 2)
    _assert_states_equal(resumed, full)
    for name in lf:
        np.testing.assert_array_equal(lr[name], lf[name])


def test_reference_checkpoint_resumes_in_the_port(small, tmp_path):
    """The reference writes a checkpoint of its state after 2 async
    rounds; the port loads it into its own state and plays rounds 2 and
    3, against the reference's rounds 2 and 3 from the same state."""
    jdata, jnets, tdata, tnets = small
    js = JServer(_cfg("j"), jdata, jnets)
    init = {k: np.asarray(v) for k, v in js.params.items()}
    jst, _ = js.engine.run_block(js.engine.init_state(js.params), 0, 2)
    assert np.asarray(jst.buf.due).min() < EMPTY_DUE
    path = str(tmp_path / "ref_ck")
    j_save(path, jst, step=2)
    ts = TServer(_cfg("t"), tdata, tnets, device="cpu",
                 init_params=params_from_jax(init, "cpu"))
    like = ts.engine.init_state(ts.params)
    st, step = load_checkpoint(path, like)
    assert step == 2
    for k, v in _leaves(st).items():
        assert v.dtype == _leaves(like)[k].dtype, k
    np.testing.assert_array_equal(st.buf.due.numpy(), np.asarray(jst.buf.due))
    np.testing.assert_array_equal(st.net.logbw.numpy(),
                                  np.asarray(jst.net.logbw))
    jst, jl = js.engine.run_block(jst, 2, 2)
    st, tl = ts.engine.run_block(st, 2, 2)
    np.testing.assert_array_equal(tl["ids"], np.asarray(jl["ids"]))
    np.testing.assert_allclose(tl["arrival"], np.asarray(jl["arrival"]),
                               rtol=1e-6)
    for name in ("due", "tau"):
        np.testing.assert_array_equal(getattr(st.buf, name).numpy(),
                                      np.asarray(getattr(jst.buf, name)))
    np.testing.assert_array_equal(st.net.channel.numpy(),
                                  np.asarray(jst.net.channel))
    np.testing.assert_array_equal(st.stale_mem.numpy(),
                                  np.asarray(jst.stale_mem))
    np.testing.assert_allclose(st.buf.vec.numpy(), np.asarray(jst.buf.vec),
                               rtol=1e-4, atol=1e-5)
    vec = np.concatenate([st.params[k].numpy().ravel()
                          for k in sorted(st.params)])
    jvec = np.concatenate([np.asarray(jst.params[k]).ravel()
                           for k in sorted(jst.params)])
    np.testing.assert_allclose(vec, jvec, rtol=1e-4, atol=1e-5)


def _tree():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(
                np.arange(64, dtype=np.float32).reshape(8, 8)),
            "b": torch.from_numpy(rng.normal(size=8).astype(np.float32)),
            "n": [torch.arange(3, dtype=torch.int32),
                  torch.zeros((0,), dtype=torch.float64)]}


def test_flipped_byte_raises_corruption_error(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, tree, step=7)
    got, step = load_checkpoint(path, tree)
    assert step == 7
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"].numpy())
    # one payload byte of "w" (2.0f, 3.0f little-endian) flipped
    raw = bytearray(open(path, "rb").read())
    i = bytes(raw).find(np.float32(2.0).tobytes() + np.float32(3.0).tobytes())
    assert i > 0
    raw[i] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorruptionError, match="w"):
        load_checkpoint(path, tree)


@pytest.mark.parametrize("keep", [0.5, 0.9, 0.0])
def test_truncated_file_raises_corruption_error(tmp_path, keep):
    tree = _tree()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, tree)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:int(len(raw) * keep)])
    with pytest.raises(CheckpointCorruptionError):
        load_checkpoint(path, tree)


def test_restore_follows_like(tmp_path):
    """Leaves take ``like``'s dtype and device and structure (dict order,
    lists); a missing step is None; a shape mismatch is a ValueError,
    not corruption; a checkpoint without CRCs loads unchecked; a missing
    file is a FileNotFoundError."""
    tree = _tree()
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree)
    like = {"n": [torch.zeros(3, dtype=torch.int64),
                  torch.zeros((0,), dtype=torch.float32)],
            "b": torch.zeros(8, dtype=torch.float64),
            "w": torch.zeros((8, 8))}
    got, step = load_checkpoint(path, like)
    assert step is None and list(got) == ["n", "b", "w"]
    assert got["n"][0].dtype == torch.int64 and got["b"].dtype == torch.float64
    assert isinstance(got["n"], list)
    np.testing.assert_array_equal(got["n"][0].numpy(), [0, 1, 2])
    np.testing.assert_array_equal(got["b"].numpy(),
                                  tree["b"].numpy().astype(np.float64))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {**like, "w": torch.zeros((4, 16))})
    old = str(tmp_path / "old.npz")
    np.savez(old, **{"w": tree["w"].numpy(), "__step__": np.asarray(3)})
    got, step = load_checkpoint(old, {"w": torch.zeros((8, 8))})
    assert step == 3
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"].numpy())
    with pytest.raises(FileNotFoundError):
        load_checkpoint(os.path.join(str(tmp_path), "absent"), like)
