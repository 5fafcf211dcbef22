"""The port's federated transformer driver (``repro_torch.launch.fl_train``)
against the JAX reference's (``repro.launch.fl_train``).

Inputs come from numpy seeds; weights are the reference's, handed over
with ``convert.model_params_from_jax`` (the CLI tests hand the port the
reference's initial weights in place of its own draw). Tolerances:
- packet masks, delivery masks and delivered-float counts: bitwise
  (threefry uniforms from the reference's keys, leaf by leaf in
  ``jax.tree_util`` order); cohorts of the host selector: bitwise;
- one FL round with SGD (lr 0.05, so the parameters carry the clipped
  debiased aggregate itself): parameters rtol 1e-5 / atol 1e-8, the
  loss, client losses and squared norms rtol 1e-5, the grad norm rtol
  1e-5;
- the per-client contributions: atol 1e-5 times the leaf's largest
  magnitude (per-client gradients, as in tests/test_torch_train.py);
- the buffer routes of the CLI against the reference's (3 rounds of
  AdamW): every round's train loss rtol 1e-4, the other round fields
  and the printed on-time counts, merges and denominators equal.
"""
import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import get_config as j_get_config
from repro.core import telemetry as j_tele
from repro.core.tra import TRAConfig as JTRAConfig
from repro.launch import fl_train as j_fl
from repro.models import transformer as j_tf
from repro_torch import prng
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.core import telemetry as t_tele
from repro_torch.convert import (model_params_from_jax, opt_state_from_jax,
                                 tree_to_numpy)
from repro_torch.core.tra import TRAConfig
from repro_torch.launch import fl_train as t_fl
from repro_torch.netsim import round_upload_seconds
from repro_torch.network.trace import sample_networks
from repro_torch.optim.optimizers import tree_leaves, tree_map, tree_paths
from repro_torch.utils.events import load_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, B, S = 4, 2, 16
SUFF = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
PART = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
SGD = dict(optimizer="sgd", lr=0.05, momentum=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are tiny, and the suite's workers
    share the cores: one torch thread, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jc = j_get_config("stablelm-3b").reduced()
    tc = get_config("stablelm-3b").reduced()
    params = jax.tree.map(np.asarray,
                          j_tf.init_params(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, jc.vocab, (C, B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    return dict(jc=jc, tc=tc, params=params, batch=batch)


def t_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def close(got, want, rtol=1e-5, atol=1e-8):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def ref_masks(params, key, rate, pf, suff, part):
    """The reference's delivery masks, leaf by leaf, as its step builds
    them."""
    leaves = jax.tree_util.tree_leaves(params)
    keys = jax.random.split(key, len(leaves) * C).reshape(len(leaves), C, 2)
    out = []
    for li, g in enumerate(leaves):
        m = jax.vmap(lambda kc: j_fl._leaf_packet_mask(kc, g.shape, rate,
                                                       pf))(keys[li])
        b = (C,) + (1,) * g.ndim
        m = jnp.maximum(m, jnp.asarray(suff).reshape(b))
        if part is not None:
            m = m * jnp.asarray(part).reshape(b)
        out.append(np.asarray(m))
    return out


def port_masks(keys_c, shape, rate, pf, suff, part):
    """(C, *shape) delivery masks of one leaf as the port's step builds
    them: ``delivered_packets`` repeated over each packet's floats."""
    n = int(np.prod(shape))
    mp = t_fl.delivered_packets(keys_c, n, rate, pf, suff, part)
    return t_fl._expand_packets(mp, n, pf).reshape((keys_c.shape[0], *shape))


@pytest.mark.parametrize("shape,rate,pf", [
    ((300,), 0.3, 256), ((2, 128, 4, 32), 0.1, 256), ((7, 5), 0.5, 4),
    ((1000,), 0.0, 256), ((513,), 1.0, 256), ((64, 3), 0.2, 7)])
def test_leaf_packet_mask_matches_reference(shape, rate, pf):
    for seed in (0, 7):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        want = np.asarray(j_fl._leaf_packet_mask(key, shape, rate, pf))
        got = t_fl._leaf_packet_mask(
            prng.fold_in(prng.PRNGKey(seed), 3), shape, rate, pf)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("part", [None, PART])
def test_round_masks_match_reference(model, part):
    """Every leaf's delivery masks for the reduced model, bitwise, in the
    reference's leaf order, and the delivered-float counts."""
    params = model["params"]
    want = ref_masks(params, jax.random.PRNGKey(1000), 0.3, 256, SUFF, part)
    tp = model_params_from_jax(params, "cpu")
    keys = t_fl.round_keys(prng.PRNGKey(1000), len(want), C)
    names = ["/".join(p) for p, _ in tree_paths(tp)]
    assert names == ["/".join(k.key for k in kp) for kp, _ in
                     jax.tree_util.tree_flatten_with_path(params)[0]]
    count = np.zeros(C, np.int64)
    for li, ((path, leaf), w) in enumerate(zip(tree_paths(tp), want)):
        got = port_masks(
            keys[li], tuple(leaf.shape), 0.3, 256, torch.tensor(SUFF),
            None if part is None else torch.tensor(part))
        np.testing.assert_array_equal(got.numpy(), w, err_msg=str(path))
        count += (w != 0).reshape(C, -1).sum(1)
    assert count[2] == count[3] == sum(x.size for x in
                                       jax.tree_util.tree_leaves(params))
    assert 0 < count[0] < count[2]


def _ref_step(model, tcfg, tra, part, key=1000):
    step, opt = j_fl.make_fl_train_step(model["jc"], JTrainConfig(**tcfg),
                                        JTRAConfig(**tra), C)
    kw = {} if part is None else {"participating": jnp.asarray(part)}
    p, s, m = jax.jit(step)(model["params"], opt.init(model["params"]),
                            model["batch"], jnp.asarray(SUFF),
                            jax.random.PRNGKey(key), **kw)
    return jax.tree.map(np.asarray, p), s, jax.tree.map(np.asarray, m)


def _port_step(model, tcfg, tra, part, key=1000):
    step, opt = t_fl.make_fl_train_step(model["tc"], TrainConfig(**tcfg),
                                        TRAConfig(**tra), C)
    tp = model_params_from_jax(model["params"], "cpu")
    kw = {} if part is None else {"participating": torch.tensor(part)}
    return step(tp, opt.init(tp), t_batch(model["batch"]),
                torch.tensor(SUFF), prng.PRNGKey(key), **kw)


@pytest.mark.parametrize("part", [None, PART], ids=["all", "cohort"])
@pytest.mark.parametrize("debias", ["per_coord_count", "group_rate", "none"])
def test_fl_step_matches_reference(model, debias, part):
    """One round, C = 4, clients 0 and 1 insufficient at 30% loss, with
    and without a cohort mask (client 1 out): the aggregate through an
    SGD step, the metrics, the delivered counts."""
    tra = dict(loss_rate=0.3, debias=debias)
    jp, _, jm = _ref_step(model, SGD, tra, part)
    tp, _, tm = _port_step(model, SGD, tra, part)
    for g, w in zip(tree_leaves(tree_to_numpy(tp)),
                    jax.tree_util.tree_leaves(jp)):
        close(g, w)
    for k in ("loss", "client_losses", "grad_norm", "client_grad_ssq"):
        close(tm[k], jm[k], atol=0)
    want = ref_masks(model["params"], jax.random.PRNGKey(1000), 0.3, 256,
                     SUFF, part)
    count = sum((w != 0).reshape(C, -1).sum(1) for w in want)
    assert tm["client_delivered"].dtype == torch.int64
    np.testing.assert_array_equal(tm["client_delivered"].numpy(), count)


def test_sweep_step_matches_reference(model):
    """S = 3 loss rates, each scenario with its own key (the sweep
    route's 1000 + i + 7919 s) and a traced f32 rate; stacked params and
    state, per-scenario metrics."""
    rates = (0.0, 0.1, 0.3)
    tra = dict(loss_rate=0.1, debias="group_rate")
    jstep, jopt = j_fl.make_fl_sweep_step(model["jc"], JTrainConfig(**SGD),
                                          JTRAConfig(**tra), C)
    tstep, topt = t_fl.make_fl_sweep_step(model["tc"], TrainConfig(**SGD),
                                          TRAConfig(**tra), C)
    stack = lambda t: jax.tree.map(  # noqa: E731
        lambda x: np.stack([x] * 3), t)
    jps = stack(model["params"])
    jss = stack(jopt.init(model["params"]))
    jkeys = jnp.stack([jax.random.PRNGKey(1000 + 7919 * s) for s in range(3)])
    jp, _, jm = jax.jit(jstep)(jps, jss, model["batch"], jnp.asarray(SUFF),
                               jkeys, jnp.asarray(rates, jnp.float32))
    tps = model_params_from_jax(jps, "cpu")
    tss = opt_state_from_jax(jax.tree.map(np.asarray, jss), "cpu")
    tkeys = torch.stack([prng.PRNGKey(1000 + 7919 * s) for s in range(3)])
    tp, ts, tm = tstep(tps, tss, t_batch(model["batch"]),
                       torch.tensor(SUFF), tkeys,
                       torch.tensor(rates, dtype=torch.float32))
    assert ts == ()
    for g, w in zip(tree_leaves(tree_to_numpy(tp)),
                    jax.tree_util.tree_leaves(jp)):
        assert g.shape[0] == 3
        close(g, w)
    for k in ("loss", "client_losses", "grad_norm", "client_grad_ssq"):
        close(tm[k], jm[k], atol=0)
    # a scenario at loss 0 delivers every float of every client
    n = sum(x.size for x in jax.tree_util.tree_leaves(model["params"]))
    assert tm["client_delivered"][0].tolist() == [n] * C


def test_contrib_and_apply_steps_match_reference(model):
    """The async decomposition at group_rate: per-client scaled
    contributions, then the apply step on a weighted numerator and its
    denominator (debias "none" and AdamW run through the reference's
    CLI in ``test_cli_routes_stream_and_render[semi_sync]``)."""
    tra = dict(loss_rate=0.3, debias="group_rate")
    jc_step, ja_step, jopt = j_fl.make_fl_contrib_step(
        model["jc"], JTrainConfig(**SGD), JTRAConfig(**tra), C)
    tc_step, ta_step, topt = t_fl.make_fl_contrib_step(
        model["tc"], TrainConfig(**SGD), TRAConfig(**tra), C)
    jcon, jl = jax.jit(jc_step)(model["params"], model["batch"],
                                jnp.asarray(SUFF), jax.random.PRNGKey(9))
    tp = model_params_from_jax(model["params"], "cpu")
    tcon, tl = tc_step(tp, t_batch(model["batch"]), torch.tensor(SUFF),
                       prng.PRNGKey(9))
    close(tl, jl, atol=0)
    for g, w in zip(tree_leaves(tree_to_numpy(tcon)),
                    jax.tree_util.tree_leaves(jcon)):
        assert g.shape[0] == C and g.dtype == np.float32
        close(g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()))
    w_c = np.array([1.0, 0.0, 1.0, 0.5], np.float32)
    jnum = jax.tree.map(lambda x: jnp.einsum("c,c...->...", w_c, x), jcon)
    tnum = tree_map(lambda x: torch.einsum("c,c...->...", torch.tensor(w_c),
                                           x), tcon)
    jp, _, jg = jax.jit(ja_step)(model["params"], (), jnum,
                                 jnp.float32(2.5))
    tp2, _, tg = ta_step(tp, (), tnum, torch.tensor(2.5))
    close(float(tg), float(jg), atol=0)
    for g, w in zip(tree_leaves(tree_to_numpy(tp2)),
                    jax.tree_util.tree_leaves(jp)):
        close(g, w)


def test_contrib_step_refuses_per_coord_count(model):
    with pytest.raises(ValueError, match="per_coord_count"):
        t_fl.make_fl_contrib_step(model["tc"], TrainConfig(),
                                  TRAConfig(debias="per_coord_count"), C)


@pytest.mark.parametrize("policy", t_fl.LAUNCH_POLICIES)
def test_selector_cohorts_match_reference(policy):
    """The host selector over 6 rounds, its memories fed the same
    metrics: cohorts bitwise."""
    assert t_fl.LAUNCH_POLICIES == j_fl.LAUNCH_POLICIES
    args = t_fl.parser().parse_args(
        ["--cohort", "3", "--clients", "8", "--selection-policy", policy,
         "--selection-temperature", "0.7"])
    jsel, jupd = j_fl._make_selector(args, 8)
    tsel, tupd = t_fl._make_selector(args, 8, torch.device("cpu"))
    rng = np.random.default_rng(4)
    for i in range(6):
        ids = tsel(i)
        np.testing.assert_array_equal(ids, jsel(i))
        m = {"client_grad_ssq": rng.random(8).astype(np.float32),
             "client_losses": rng.random(8).astype(np.float32)}
        jupd(ids, m)
        tupd(ids, {k: torch.tensor(v) for k, v in m.items()})


def _flstat(monkeypatch):
    """tools/flstat.py as a module; the ``sys.path`` entry it adds goes
    when the test ends."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "flstat", os.path.join(ROOT, "tools", "flstat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _async_deadline():
    """A deadline between the synthetic-mlp clients' upload times, so
    some are on time and some late (the reference's delivery model)."""
    cfg = get_config("synthetic-mlp")
    from repro_torch.models import transformer as t_tf
    n = sum(x.numel() for x in tree_leaves(
        t_tf.init_params(cfg, torch.Generator().manual_seed(0))))
    mbps = sample_networks(np.random.default_rng(0), C).upload_mbps
    secs = round_upload_seconds(-(-n // 256), 256, torch.tensor(
        mbps, dtype=torch.float32), torch.tensor(0.1),
        torch.tensor([False, True, True, True])).numpy()
    s = np.sort(secs)
    return float(0.5 * (s[1] + s[2]))


ROUTES = {
    "single": [],
    "cohort": ["--cohort", "2", "--selection-policy", "loss_aware"],
    "sweep": ["--sweep-loss-rates", "0.0,0.1,0.3", "--debias",
              "group_rate"],
    "async": ["--server-mode", "async", "--debias", "group_rate",
              "--buffer-k", "2"],
    "semi_sync": ["--server-mode", "semi_sync", "--debias", "none",
                  "--recovery", "arq"],
}
# the routes whose host logic (delivery, the buffer, staleness weights)
# the tests also run through the reference's CLI; the others' steps are
# held to the reference above
REF_ROUTES = ("async", "semi_sync")


def _argv(route):
    argv = ["--arch", "synthetic-mlp", "--steps", "3", "--seq", "16",
            "--telemetry", "scalars", *ROUTES[route]]
    if route in ("async", "semi_sync"):
        argv += ["--deadline-s", repr(_async_deadline()), "--grace-s", "100"]
    return argv


def _render(path, monkeypatch):
    """tools/flstat.py's summary, ledger and JSON views of a stream."""
    flstat = _flstat(monkeypatch)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert flstat.main([path]) == 0
        assert flstat.main([path, "--rounds"]) == 0
        assert flstat.main([path, "--programs"]) == 0
    assert "launch" in buf.getvalue()
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert flstat.main([path, "--json"]) == 0
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cli_routes_stream_and_render(route, tmp_path, monkeypatch):
    """``main(argv)`` in-process on synthetic-mlp, 3 rounds, C = 4,
    ``--telemetry scalars --events-out``, on the CPU: the stream loads,
    its records carry the route's fields, tools/flstat.py renders it.
    For the buffer routes the reference's CLI runs beside it from the
    same initial weights: every round record agrees, and so do the
    printed on-time counts, merges and denominators."""
    jparams = j_tf.init_params(j_get_config("synthetic-mlp"),
                               jax.random.PRNGKey(0))
    monkeypatch.setattr(t_fl, "_init", lambda cfg, dev: model_params_from_jax(
        jparams, dev))
    # registries of this test's own: the process-wide ones stay as they
    # were for the other tests in this process
    monkeypatch.setattr(t_tele, "REGISTRY", t_tele.ProgramRegistry())
    monkeypatch.setattr(j_tele, "REGISTRY", j_tele.ProgramRegistry())
    argv = _argv(route)
    tpath = str(tmp_path / "t.jsonl")
    tout = io.StringIO()
    with redirect_stdout(tout):
        assert t_fl.main(argv + ["--events-out", tpath,
                                 "--device", "cpu"]) == 0
    th, tr, tprog = load_stream(tpath)
    assert th["env"]["backend"] == "cpu"
    assert th["meta"]["route"] == {"cohort": "single", "semi_sync": "async"
                                   }.get(route, route)
    n_sc = 3 if route == "sweep" else 1
    assert len(tr) == 3 * n_sc
    assert all(np.isfinite(r.train_loss) for r in tr)
    if route == "sweep":
        assert [r.realized_loss for r in tr] == [0.0, 0.1, 0.3] * 3
    if route == "cohort":
        assert all(len(r.cohort) == 2 for r in tr)
    if route in ("async", "semi_sync"):
        # some clients on time, some late
        assert len({r.delivered_frac for r in tr}) == 1
        assert 0.0 < tr[0].delivered_frac < 1.0
    assert [p["cache"] for p in tprog] == ["launch"] * (
        2 if route in ("async", "semi_sync") else 1)
    summary = _render(tpath, monkeypatch)
    assert len(summary["scenarios"]) == n_sc
    if route not in REF_ROUTES:
        return
    jpath = str(tmp_path / "j.jsonl")
    jout = io.StringIO()
    with redirect_stdout(jout):
        assert j_fl.main(argv + ["--events-out", jpath]) == 0
    jh, jr, _ = load_stream(jpath)
    assert th["meta"] == jh["meta"]
    assert th["config_fingerprint"] == jh["config_fingerprint"]
    assert len(jr) == len(tr)
    for a, b in zip(tr, jr):
        da, db = a.to_json(), b.to_json()
        close(da.pop("train_loss"), db.pop("train_loss"), rtol=1e-4, atol=0)
        assert da == db
    tail = [ln.split("loss=")[1].split(" ", 2)[2].split("(")[0]
            for out in (tout, jout) for ln in
            out.getvalue().splitlines()[-3:]]
    assert tail[:3] == tail[3:]


def test_cli_refusals():
    for argv, msg in (
            (["--telemetry", "scalars"], "--events-out"),
            (["--events-out", "x.jsonl"], "--telemetry"),
            (["--server-mode", "async"], "group_rate or none"),
            (["--server-mode", "async", "--cohort", "2"], "single-scenario"),
            (["--sweep-loss-rates", "0.1,0.2", "--cohort", "2"], "sweep"),
            (["--cohort", "9"], "--cohort must be")):
        err = io.StringIO()
        with pytest.raises(SystemExit), redirect_stdout(io.StringIO()), \
                redirect_stderr(err):
            t_fl.main(["--arch", "synthetic-mlp", "--steps", "1",
                       "--device", "cpu", *argv])
        assert msg in err.getvalue(), (argv, err.getvalue())


def test_fl_cli_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_fl.main(["--arch", "synthetic-mlp", "--steps", "1"])


def test_dense_path_refuses_other_families():
    cfg = get_config("mixtral-8x22b").reduced()
    step, _ = t_fl.make_fl_train_step(cfg, TrainConfig(), TRAConfig(), C)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        step({}, {}, {"tokens": torch.zeros((C, 1, 4), dtype=torch.int32)},
             torch.tensor(SUFF), prng.PRNGKey(0))
