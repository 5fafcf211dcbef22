"""END-TO-END DRIVER: loss-tolerant federated training of a transformer
(the reference's ``repro/launch/fl_train.py``).

The paper's protocol in the training step:

  * per-client gradients, one client at a time (the reference vmaps
    ``value_and_grad`` over the client axis; the values are the same);
  * each *insufficient* client's upload is packet-masked per leaf
    (packets of 256 f32 coordinates, the TRA "throw" step), the
    per-packet uniforms drawn with ``repro_torch.prng``'s threefry from
    the reference's keys, so every mask is the reference's bit for bit;
  * aggregation is the debiased masked mean (paper Eq. 1 and its
    per-coordinate and biased variants);
  * the optimizer consumes the debiased aggregate.

The parameter tree is walked in ``jax.tree_util`` order (dict keys
sorted at every level): the ``L * C`` keys split from a round's key are
assigned leaf by leaf in that order, as in the reference.

``python -m repro_torch.launch.fl_train --arch stablelm-3b --reduced``
runs a small cohort end to end; without ``--device cpu`` it needs the
card. Routes: the single-scenario loop (optionally with a host-side
selector), ``--sweep-loss-rates`` (S replicas in one step) and
``--server-mode semi_sync|async`` (the host-side arrival buffer).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig, TrainConfig, get_config
from repro_torch.core import telemetry as tele_mod
from repro_torch.core.tra import TRAConfig
from repro_torch.device import resolve_device
from repro_torch.launch.steps import value_and_grad
from repro_torch.launch.train import synth_batch
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          make_optimizer, tree_leaves,
                                          tree_map, tree_unflatten)
from repro_torch.utils.events import EventWriter, RoundRecord, fingerprint_of
from repro_torch.utils.guards import assert_finite_tree


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def packet_keep(key, n: int, loss_rate, packet_floats: int) -> torch.Tensor:
    """(P,) f32 per-packet Bernoulli keep mask, u >= rate, of a leaf of
    ``n`` floats in packets of ``packet_floats``."""
    u = prng.uniform(key, (-(-n // packet_floats),))
    return (u >= _f32(loss_rate, u.device)).to(torch.float32)


def _leaf_packet_mask(key, shape, loss_rate, packet_floats: int):
    """Per-packet Bernoulli keep mask broadcast to a leaf's shape: each
    packet's value repeated over its floats."""
    n = int(np.prod(shape))
    m = packet_keep(key, n, loss_rate, packet_floats)
    flat = m[:, None].expand(m.shape[0], packet_floats).reshape(-1)[:n]
    return flat.reshape(shape)


def round_keys(key, n_leaves: int, n_clients: int) -> torch.Tensor:
    """(L, C, 2): one key per leaf and client, split from the round's."""
    return prng.split(key, n_leaves * n_clients).reshape(
        n_leaves, n_clients, 2)


def delivered_packets(keys_c, n: int, rate, packet_floats: int, sufficient,
                      participating=None) -> torch.Tensor:
    """(C, P) f32 per-packet delivery of one leaf of ``n`` floats: the
    packet masks of ``keys_c`` (C, 2), full for sufficient clients (they
    retransmit), zero for clients outside the cohort."""
    C = keys_c.shape[0]
    m = torch.stack([packet_keep(keys_c[c], n, rate, packet_floats)
                     for c in range(C)])
    m = torch.maximum(m, sufficient[:, None].to(m.dtype))
    if participating is not None:
        m = m * participating[:, None]
    return m


def _expand_packets(mp, n: int, packet_floats: int) -> torch.Tensor:
    """(R, P) per-packet values -> (R, n): each repeated over its floats."""
    R, P = mp.shape
    return mp[:, :, None].expand(R, P, packet_floats).reshape(
        R, P * packet_floats)[:, :n]


def _times_packets(x, mp, packet_floats: int) -> torch.Tensor:
    """x (C, ...) times its per-packet mask ``mp`` (C, P), the same
    products as times the float-level mask; where the packets tile the
    leaf, through a broadcast view, with no float-level mask built."""
    C, P = mp.shape
    n = x[0].numel()
    if n == P * packet_floats:
        return (x.reshape(C, P, packet_floats)
                * mp[:, :, None].to(x.dtype)).reshape(x.shape)
    return x * _expand_packets(mp, n, packet_floats).reshape(
        x.shape).to(x.dtype)


def _delivered_floats(mp, n: int, packet_floats: int) -> torch.Tensor:
    """(C,) int64 floats delivered: each kept packet's floats (the last
    packet holds the leaf's remainder)."""
    w = torch.full((mp.shape[1],), packet_floats, dtype=torch.int64,
                   device=mp.device)
    w[-1] = n - (mp.shape[1] - 1) * packet_floats
    return ((mp != 0).to(torch.int64) * w).sum(1)


def _inv_keep(rate, device) -> torch.Tensor:
    """1 / max(1 - rate, 1e-6) in f32. A Python rate is subtracted in
    double and rounded once, a tensor rate in f32, as the reference's
    closure constant and traced rate are."""
    if isinstance(rate, torch.Tensor):
        keep = torch.clamp(1.0 - rate.to(torch.float32), min=1e-6)
    else:
        keep = _f32(max(1.0 - rate, 1e-6), device)
    return 1.0 / keep


def client_grads(cfg: ModelConfig, params, batch, n_clients: int, remat):
    """(losses (C,), the gradient leaves in tree order, each (C, ...)):
    each client's loss and gradient on its slice of ``batch``."""
    losses: List[torch.Tensor] = []
    bufs: Optional[List[torch.Tensor]] = None
    for c in range(n_clients):
        b = {k: v[c] for k, v in batch.items()}
        (loss, _), g = value_and_grad(
            lambda p: tf.forward(cfg, p, b, remat=remat), params)
        g_leaves = tree_leaves(g)
        del g
        if bufs is None:
            bufs = [torch.empty((n_clients, *x.shape), dtype=x.dtype,
                                device=x.device) for x in g_leaves]
        for buf, x in zip(bufs, g_leaves):
            buf[c] = x
        del g_leaves
        losses.append(loss)
    return torch.stack(losses), bufs


def _client_ssq(leaves) -> torch.Tensor:
    """(C,) per-client squared update norms, leaves added in order."""
    ssq = 0
    for g in leaves:
        ssq = ssq + g.float().square().sum(dim=tuple(range(1, g.dim())))
    return ssq


def make_fl_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                       tra: TRAConfig, n_clients: int):
    """Returns (fl_step, opt). Batch leaves carry a leading client axis C.

    ``loss_rate`` is an optional override of ``tra.loss_rate`` (a () f32
    tensor in the sweep); ``participating`` an optional (C,) f32 cohort
    mask: non-members contribute nothing and the mean runs over the
    cohort size. Metrics: the reference's ``loss``, ``client_losses``,
    ``grad_norm`` and ``client_grad_ssq``, and ``client_delivered``, the
    (C,) int64 count of floats each client delivered."""
    opt = make_optimizer(tcfg.optimizer, tcfg.lr, momentum=tcfg.momentum,
                         weight_decay=tcfg.weight_decay)
    remat = tcfg.remat != "none"

    def fl_step(params, opt_state, batch, sufficient, key, loss_rate=None,
                participating=None):
        rate = tra.loss_rate if loss_rate is None else loss_rate
        # --- thread Client: local gradient computation ------------------
        losses, leaves = client_grads(cfg, params, batch, n_clients, remat)
        client_ssq = _client_ssq(leaves)

        # --- TRA upload + debiased aggregation (Eq. 1 family) -----------
        keys = round_keys(key, len(leaves), n_clients)
        dev = losses.device
        delivered = torch.zeros(n_clients, dtype=torch.int64, device=dev)
        if participating is not None:
            denom = torch.clamp(participating.sum(), min=1.0)
        agg_leaves = []
        pf = tra.packet_floats
        for li in range(len(leaves)):
            g = leaves[li]
            lf_shape = tuple(g.shape[1:])
            n = g[0].numel()
            mp = delivered_packets(keys[li], n, rate, pf, sufficient,
                                   participating)
            delivered += _delivered_floats(mp, n, pf)
            suff = sufficient.reshape((n_clients,) + (1,) * len(lf_shape))
            gm = _times_packets(g, mp, pf)
            if tra.debias == "per_coord_count":
                num = _times_packets(gm.float(), mp, pf).sum(0)
                den = torch.clamp(_expand_packets(
                    mp.sum(0, keepdim=True), n, pf).reshape(lf_shape),
                    min=1e-9)
                agg = num / den
            elif tra.debias == "group_rate":   # paper Eq. (1), corrected
                scale = torch.where(suff.bool(), 1.0, _inv_keep(rate, dev))
                gs = gm.float() * scale
                agg = gs.sum(0) / denom if participating is not None \
                    else gs.mean(0)
            else:                              # "none": biased mean
                gf = gm.float()
                agg = gf.sum(0) / denom if participating is not None \
                    else gf.mean(0)
            agg_leaves.append(agg.to(g.dtype))
            leaves[li] = None                  # this client stack is done
            del g, gm
        agg_grads = tree_unflatten(params, agg_leaves)
        del agg_leaves

        # --- thread Server: optimizer update ----------------------------
        if tcfg.grad_clip > 0:
            agg_grads, gnorm = clip_by_global_norm(agg_grads, tcfg.grad_clip)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.no_grad():
            updates, opt_state = opt.update(agg_grads, opt_state, params)
            params = apply_updates(params, updates)
        metrics = {"loss": losses.mean(), "client_losses": losses,
                   "grad_norm": gnorm, "client_grad_ssq": client_ssq,
                   "client_delivered": delivered}
        return params, opt_state, metrics

    return fl_step, opt


def make_fl_contrib_step(cfg: ModelConfig, tcfg: TrainConfig,
                         tra: TRAConfig, n_clients: int):
    """The async-server decomposition of ``make_fl_train_step``:

    ``contrib_step(params, batch, sufficient, key)`` returns the
    per-client debias-SCALED masked gradient contributions (a tree with
    a leading client axis C, f32) and the per-client losses: the
    numerator terms of the aggregate before the cross-client mean. The
    host decides which land this round, which wait in the arrival
    buffer and with what staleness weight, then calls
    ``apply_step(params, opt_state, num, den)`` with the recombined
    numerator and denominator. Only ``group_rate``/``none`` debias is
    supported: the per-coordinate denominator is gradient-shaped."""
    if tra.debias == "per_coord_count":
        raise ValueError("per_coord_count debias has a per-coordinate "
                         "denominator and cannot ride the scalar-weight "
                         "arrival buffer; use group_rate or none")
    opt = make_optimizer(tcfg.optimizer, tcfg.lr, momentum=tcfg.momentum,
                         weight_decay=tcfg.weight_decay)
    remat = tcfg.remat != "none"

    def contrib_step(params, batch, sufficient, key):
        rate = tra.loss_rate
        losses, leaves = client_grads(cfg, params, batch, n_clients, remat)
        keys = round_keys(key, len(leaves), n_clients)
        out = []
        for li in range(len(leaves)):
            g = leaves[li]
            lf_shape = tuple(g.shape[1:])
            mp = delivered_packets(keys[li], g[0].numel(), rate,
                                   tra.packet_floats, sufficient)
            suff = sufficient.reshape((n_clients,) + (1,) * len(lf_shape))
            gm = _times_packets(g, mp, tra.packet_floats).float()
            if tra.debias == "group_rate":
                gm = gm * torch.where(suff.bool(), 1.0,
                                      _inv_keep(rate, g.device))
            out.append(gm)
            leaves[li] = None
        return tree_unflatten(params, out), losses

    def apply_step(params, opt_state, num, den):
        agg_grads = tree_map(lambda n, p: (n / den).to(p.dtype), num, params)
        if tcfg.grad_clip > 0:
            agg_grads, gnorm = clip_by_global_norm(agg_grads, tcfg.grad_clip)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=den.device)
        with torch.no_grad():
            updates, opt_state = opt.update(agg_grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, gnorm

    return contrib_step, apply_step, opt


def _index(tree, s: int):
    if isinstance(tree, dict):
        return {k: _index(v, s) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, s) for v in tree)
    return tree[s]


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[i] for t in trees])
                     for i in range(len(first)))
    return torch.stack(trees)


def make_fl_sweep_step(cfg: ModelConfig, tcfg: TrainConfig,
                       tra: TRAConfig, n_clients: int):
    """Scenario-batched FL step: ``fl_step`` over a leading scenario axis
    on (params, opt_state, key, loss_rate), with the batch and the
    sufficiency reports shared. The reference vmaps; the port walks the
    scenarios in order, each with its traced rate (a () f32 tensor).

    Returns (sweep_step, opt); sweep_step(params_S, opt_state_S, batch,
    sufficient, keys_S, loss_rates_S) -> (params_S, opt_state_S,
    metrics with leading S)."""
    fl_step, opt = make_fl_train_step(cfg, tcfg, tra, n_clients)

    def sweep_step(params_s, opt_s, batch, sufficient, keys_s, rates_s):
        outs = [fl_step(_index(params_s, s), _index(opt_s, s), batch,
                        sufficient, keys_s[s], rates_s[s])
                for s in range(keys_s.shape[0])]
        return (_stack([o[0] for o in outs]), _stack([o[1] for o in outs]),
                _stack([o[2] for o in outs]))

    return sweep_step, opt


def _init(cfg, dev):
    return tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))


def _client_batch(cfg, args, rng, dev):
    batches = [synth_batch(cfg, args.batch, args.seq, rng, device=dev)
               for _ in range(args.clients)]
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def _sufficient(args, dev):
    C = args.clients
    return _f32([0.0] * args.insufficient + [1.0] * (C - args.insufficient),
                dev)


def _run_sweep(cfg, tcfg, tra, args, rates, dev):
    """Grid route: one model replica per TRA loss rate, all trained by
    one step (scenario axis = loss rate; per-scenario keys)."""
    S, C = len(rates), args.clients
    params = _init(cfg, dev)
    sweep_step, opt = make_fl_sweep_step(cfg, tcfg, tra, C)
    opt_state = opt.init(params)
    params_s = _stack([params] * S)
    opt_s = _stack([opt_state] * S)
    del params, opt_state
    sweep_step = _timed(sweep_step, "sweep", args)
    loss_rates = _f32(rates, dev)
    sufficient = _sufficient(args, dev)
    rng = np.random.default_rng(0)
    writer = _open_writer(args, "sweep", dev)
    try:
        for i in range(args.steps):
            batch = _client_batch(cfg, args, rng, dev)
            keys = torch.stack([prng.PRNGKey(1000 + i + 7919 * s, dev)
                                for s in range(S)])
            t0 = time.time()
            params_s, opt_s, m = sweep_step(params_s, opt_s, batch,
                                            sufficient, keys, loss_rates)
            losses = m["loss"].cpu().numpy()
            per = " ".join(f"r={r:.2f}:{l:8.4f}"
                           for r, l in zip(rates, losses))
            print(f"round {i:4d} {per} ({time.time()-t0:.2f}s)",
                  flush=True)
            if writer is not None:
                for s in range(S):
                    writer.write_round(RoundRecord(
                        round=i, scenario=s,
                        train_loss=float(losses[s]),
                        realized_loss=float(rates[s])))
            if not np.all(np.isfinite(losses)):
                # fail fast naming the bad scenario/leaf, not loss=nan
                assert_finite_tree(params_s, name=f"round{i}/params")
                assert_finite_tree({"loss": m["loss"]}, name=f"round{i}")
    finally:
        if writer is not None:
            writer.write_program_stats(tele_mod.REGISTRY.stats())
            writer.close()
    return 0


def _run_async(cfg, tcfg, tra, args, dev):
    """Host-driven ``--server-mode semi_sync|async`` route: each round
    every client computes its contribution; the delivery model
    (per-client FCC-trace bandwidth, TRA retransmission inflation)
    decides who beats ``--deadline-s``. Late contributions wait in a
    host-side buffer (the ``--buffer-k`` earliest-due win) and merge
    into the round they arrive in with the staleness discount w(tau) =
    (1+tau)^(-alpha); semi_sync instead folds within-grace stragglers
    into the CURRENT round with the fractional discount and drops the
    rest. A round with no arrivals leaves params untouched."""
    from repro_torch.core.async_agg import staleness_weight
    from repro_torch.netsim import (MAX_LATENESS, arrival_lateness,
                                    grace_staleness, round_upload_seconds)
    from repro_torch.network.trace import sample_networks

    C = args.clients
    params = _init(cfg, dev)
    n_params = sum(int(np.prod(x.shape)) for x in tree_leaves(params))
    n_pkts = -(-n_params // tra.packet_floats)
    contrib_step, apply_step, opt = make_fl_contrib_step(cfg, tcfg, tra, C)
    opt_state = opt.init(params)
    contrib_step = _timed(contrib_step, "async_contrib", args)
    apply_step = _timed(apply_step, "async_apply", args)
    sufficient = _sufficient(args, dev)
    mbps = sample_networks(np.random.default_rng(0), C).upload_mbps
    secs_t = round_upload_seconds(
        n_pkts, tra.packet_floats, _f32(mbps, "cpu"),
        _f32(args.loss_rate, "cpu"), sufficient.cpu().bool())
    secs = secs_t.numpy()                                # (C,) static here
    lateness = arrival_lateness(secs_t, _f32(args.deadline_s, "cpu")).numpy()
    alpha = args.staleness_alpha
    buffer: List[Any] = []       # [(due, w_tau, contrib tree)] host-side
    rng = np.random.default_rng(0)
    writer = _open_writer(args, "async", dev)
    for i in range(args.steps):
        batch = _client_batch(cfg, args, rng, dev)
        t0 = time.time()
        contribs, losses = contrib_step(params, batch, sufficient,
                                        prng.PRNGKey(1000 + i, dev))
        if args.server_mode == "semi_sync":
            within = secs <= args.deadline_s + args.grace_s
            gtau = grace_staleness(secs_t, _f32(args.deadline_s, "cpu"))
            w_c = np.where(lateness == 0, 1.0,
                           np.where(within, staleness_weight(
                               gtau, _f32(alpha, "cpu")).numpy(), 0.0))
        else:                                            # async
            w_c = (lateness == 0).astype(np.float32)
        w_dev = _f32(w_c, dev)
        num = tree_map(lambda x: torch.einsum("c,c...->...", w_dev, x),
                       contribs)
        den = float(w_c.sum())
        ready = [e for e in buffer if e[0] <= i]
        buffer = [e for e in buffer if e[0] > i]
        for due, w_tau, con in ready:
            num = tree_map(lambda n, c: n + w_tau * c, num, con)
            den += w_tau
        if args.server_mode == "async":
            for c in range(C):
                if 0 < lateness[c] < MAX_LATENESS:
                    w_tau = float(staleness_weight(
                        _f32(lateness[c], "cpu"), _f32(alpha, "cpu")))
                    buffer.append((i + int(lateness[c]), w_tau,
                                   tree_map(lambda x: x[c], contribs)))
            buffer = sorted(buffer, key=lambda e: e[0])[:args.buffer_k]
        if den > 0:
            params, opt_state, _ = apply_step(params, opt_state, num,
                                              _f32(den, dev))
        loss = float(losses.mean())
        print(f"round {i:4d} loss={loss:8.4f} "
              f"ontime={int((lateness == 0).sum())}/{C} "
              f"buffered={len(ready)}->merged den={den:.3f} "
              f"({time.time()-t0:.2f}s)", flush=True)
        if writer is not None:
            writer.write_round(RoundRecord(
                round=i, train_loss=loss,
                arrival_mean=float(np.mean(w_c)),
                buf_fill=len(buffer) / max(args.buffer_k, 1),
                delivered_frac=float((lateness == 0).mean())))
        if not np.isfinite(loss):
            # name the offending leaf (params or the loss itself)
            assert_finite_tree(params, name=f"round{i}/params")
            assert_finite_tree({"loss": losses}, name=f"round{i}")
    if writer is not None:
        writer.write_program_stats(tele_mod.REGISTRY.stats())
        writer.close()
    return 0


def _open_writer(args, route: str, dev=None):
    """Host-side telemetry writer for the launch routes: records carry
    only the signals the route observes (absent fields mean "not
    instrumented here", the event schema's contract)."""
    if args.telemetry == "off":
        return None
    return EventWriter(
        args.events_out,
        config_fingerprint=fingerprint_of(
            (args.arch, route, args.clients, args.insufficient,
             args.loss_rate, args.debias, args.server_mode)),
        meta={"route": route, "arch": args.arch,
              "n_clients": args.clients, "steps": args.steps,
              "telemetry_level": args.telemetry},
        device=dev)


def _timed(fn, route: str, args):
    """Register a launch route's step in the program registry and wrap
    it in a ``TimedProgram`` (host dispatch time per call)."""
    if args.telemetry == "off":
        return fn
    fp = tele_mod.REGISTRY.record_lookup(
        "launch", (args.arch, route, args.clients, args.debias,
                   args.server_mode), hit=False)
    return tele_mod.TimedProgram(fn, "launch", fp)


# Selection policies the host-driven launch loop supports. netsim_state
# is excluded: its score is the engine's device-resident Gilbert–Elliott
# channel state, which this driver does not simulate.
LAUNCH_POLICIES = ("uniform", "bandwidth_threshold", "gradient_norm",
                   "loss_aware")


def _make_selector(args, n_clients: int, dev):
    """Host-side round selector: (select, update) closures over the
    per-client score memories (select reads the memories as of the
    PREVIOUS round; update scatters this round's cohort metrics)."""
    from repro_torch.core import selection as sel_mod
    from repro_torch.network.trace import (log_upload_speeds,
                                           sample_networks)

    nets = sample_networks(np.random.default_rng(0), n_clients)
    logbw = log_upload_speeds(nets.upload_mbps, device=dev)
    gnorm_mem = np.zeros(n_clients, np.float32)
    loss_mem = np.zeros(n_clients, np.float32)
    eligible = torch.ones(n_clients, dtype=torch.bool, device=dev)

    def select(step_idx: int) -> np.ndarray:
        logits = sel_mod.policy_logits(
            args.selection_policy,
            temperature=_f32(args.selection_temperature, dev),
            explore=_f32(0.0, dev), threshold_mbps=_f32(2.0, dev),
            logbw=logbw, gnorm_mem=_f32(gnorm_mem, dev),
            loss_mem=_f32(loss_mem, dev))
        key = prng.fold_in(prng.PRNGKey(500, dev), step_idx)
        return sel_mod.select_clients(key, logits, eligible,
                                      args.cohort).cpu().numpy()

    def update(ids: np.ndarray, metrics: Dict[str, Any]):
        gnorm_mem[ids] = metrics["client_grad_ssq"].cpu().numpy()[ids]
        loss_mem[ids] = metrics["client_losses"].cpu().numpy()[ids]

    return select, update


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--insufficient", type=int, default=1,
                    help="# clients with lossy uploads")
    ap.add_argument("--loss-rate", type=float, default=0.1)
    ap.add_argument("--cohort", type=int, default=None,
                    help="clients selected per round; default: every "
                         "client participates")
    ap.add_argument("--selection-policy", default="uniform",
                    choices=LAUNCH_POLICIES,
                    help="host-driven cohort selection score "
                         "(core/selection.py; netsim_state needs the "
                         "engine's channel state and is engine-only)")
    ap.add_argument("--selection-temperature", type=float, default=1.0)
    ap.add_argument("--server-mode", default="sync",
                    choices=("sync", "semi_sync", "async"),
                    help="sync drops deadline stragglers; semi_sync folds "
                         "within-grace stragglers into the round with a "
                         "staleness discount; async buffers them "
                         "host-side and merges them at arrival")
    ap.add_argument("--deadline-s", type=float, default=0.5,
                    help="upload deadline for the non-sync server modes")
    ap.add_argument("--grace-s", type=float, default=0.5,
                    help="semi_sync window after the deadline")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="w(tau) = (1+tau)^(-alpha) staleness discount")
    ap.add_argument("--buffer-k", type=int, default=8,
                    help="async arrival-buffer slots (earliest-due win)")
    ap.add_argument("--recovery", default="one_shot",
                    choices=("one_shot", "fec", "arq"),
                    help="uplink recovery policy, at the RATE level: the "
                         "closed-form residual loss rate "
                         "(netsim/recovery.residual_loss_rate) replaces "
                         "the TRA channel's rate")
    ap.add_argument("--arq-retries", type=float, default=2.0,
                    help="max ARQ retransmit rounds (--recovery arq)")
    ap.add_argument("--fec-group", type=int, default=8,
                    help="FEC parity group size G (--recovery fec)")
    ap.add_argument("--sweep-loss-rates", default=None,
                    help="comma-separated TRA loss rates, e.g. "
                         "'0.0,0.1,0.3': train every scenario in one step "
                         "(S replicas)")
    ap.add_argument("--debias", default="per_coord_count")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--telemetry", default="off",
                    choices=("off", "scalars", "full"),
                    help="host-side telemetry level; any non-off level "
                         "streams per-round records to --events-out")
    ap.add_argument("--events-out", default=None,
                    help="JSONL event-stream path (tools/flstat.py "
                         "renders it); required when --telemetry is on")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace (Perfetto / "
                         "chrome://tracing) covering the training loop")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.telemetry != "off" and not args.events_out:
        ap.error("--telemetry scalars|full needs --events-out PATH")
    if args.events_out and args.telemetry == "off":
        ap.error("--events-out needs --telemetry scalars|full")
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(lr=args.lr)
    if args.recovery != "one_shot":
        from repro_torch.netsim.recovery import residual_loss_rate
        eff = float(residual_loss_rate(
            args.recovery, args.loss_rate,
            retries=args.arq_retries, group=args.fec_group))
        print(f"recovery={args.recovery}: nominal loss "
              f"{args.loss_rate:.3f} -> residual {eff:.5f}", flush=True)
        args.loss_rate = eff
        if args.sweep_loss_rates:
            rates = [float(x) for x in args.sweep_loss_rates.split(",")]
            args.sweep_loss_rates = ",".join(
                str(float(residual_loss_rate(
                    args.recovery, r, retries=args.arq_retries,
                    group=args.fec_group))) for r in rates)
    tra = TRAConfig(loss_rate=args.loss_rate, debias=args.debias)
    prof = contextlib.nullcontext()
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    with prof:
        out = _dispatch(ap, args, cfg, tcfg, tra, dev)
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))
    return out


def _dispatch(ap, args, cfg, tcfg, tra, dev):
    if args.server_mode != "sync":
        if args.sweep_loss_rates or args.cohort is not None:
            ap.error("--server-mode semi_sync/async is a single-scenario "
                     "full-participation route (the arrival buffer is "
                     "host-side per client)")
        if args.deadline_s <= 0:
            ap.error("--server-mode semi_sync/async needs --deadline-s > 0")
        if tra.debias == "per_coord_count":
            ap.error("--server-mode semi_sync/async needs --debias "
                     "group_rate or none (per-coord denominators cannot "
                     "ride the scalar-weight arrival buffer)")
        return _run_async(cfg, tcfg, tra, args, dev)
    if args.sweep_loss_rates:
        if args.cohort is not None:
            ap.error("--cohort is not supported on the sweep route "
                     "(per-scenario cohorts would break the shared "
                     "batch); use the single-scenario route")
        rates = [float(x) for x in args.sweep_loss_rates.split(",")]
        return _run_sweep(cfg, tcfg, tra, args, rates, dev)
    C = args.clients
    if args.cohort is not None and not 0 < args.cohort <= C:
        ap.error(f"--cohort must be in [1, {C}]")
    params = _init(cfg, dev)
    fl_step, opt = make_fl_train_step(cfg, tcfg, tra, C)
    opt_state = opt.init(params)
    fl_step = _timed(fl_step, "single", args)
    sufficient = _sufficient(args, dev)
    select = update = None
    if args.cohort is not None:
        select, update = _make_selector(args, C, dev)
    rng = np.random.default_rng(0)
    writer = _open_writer(args, "single", dev)
    try:
        for i in range(args.steps):
            batch = _client_batch(cfg, args, rng, dev)
            t0 = time.time()
            participating, ids = None, None
            if select is not None:
                ids = select(i)
                mask = np.zeros(C, np.float32)
                mask[ids] = 1.0
                participating = _f32(mask, dev)
            params, opt_state, m = fl_step(params, opt_state, batch,
                                           sufficient,
                                           prng.PRNGKey(1000 + i, dev),
                                           participating=participating)
            if update is not None:
                update(ids, m)
            loss = float(m["loss"])
            cohort_note = ("" if ids is None
                           else f" cohort={sorted(ids.tolist())}")
            print(f"round {i:4d} loss={loss:8.4f} "
                  f"clients={m['client_losses'].cpu().numpy().round(3)}"
                  f"{cohort_note} ({time.time()-t0:.2f}s)", flush=True)
            if writer is not None:
                writer.write_round(RoundRecord(
                    round=i, train_loss=loss,
                    cohort=(sorted(int(x) for x in ids)
                            if ids is not None else None),
                    realized_loss=float(args.loss_rate)))
            if not np.isfinite(loss):
                # a NaN loss means either the model diverged or an
                # upload poisoned the aggregate: name the leaf
                assert_finite_tree(params, name=f"round{i}/params")
                assert_finite_tree(m, name=f"round{i}/metrics")
    finally:
        if writer is not None:
            writer.write_program_stats(tele_mod.REGISTRY.stats())
            writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
