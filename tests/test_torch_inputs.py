"""Host-side inputs of the port against the JAX reference: packet
arithmetic, the FCC network model, eligibility masks, the synthetic
dataset and its device staging. Same ``np.random.Generator`` seed, same
arrays: every comparison here is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as j_syn
from repro.network import packets as j_pk
from repro.network import trace as j_tr
from repro_torch.data import synthetic as t_syn
from repro_torch.network import packets as t_pk
from repro_torch.network import trace as t_tr


@pytest.mark.parametrize("d", [1, 255, 256, 257, 9098])
def test_n_packets_and_coordinate_mask(d):
    assert t_pk.n_packets(d) == j_pk.n_packets(d)
    assert t_pk.n_packets(d, 32) == j_pk.n_packets(d, 32)
    P = j_pk.n_packets(d, 32)
    m = (np.random.default_rng(d).random(P) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        t_pk.coordinate_mask(torch.from_numpy(m), d, 32).numpy(),
        np.asarray(j_pk.coordinate_mask(jnp.asarray(m), d, 32)))
    v = np.arange(d, dtype=np.float32)
    np.testing.assert_array_equal(
        t_pk.pad_to_packets(torch.from_numpy(v), 32).numpy(),
        np.asarray(j_pk.pad_to_packets(jnp.asarray(v), 32)))


def test_sample_networks_equal():
    j = j_tr.sample_networks(np.random.default_rng(3), 50)
    t = t_tr.sample_networks(np.random.default_rng(3), 50)
    np.testing.assert_array_equal(t.upload_mbps, j.upload_mbps)
    np.testing.assert_array_equal(t.packet_loss, j.packet_loss)
    np.testing.assert_array_equal(t_tr.eligible_by_ratio(t, 0.7),
                                  j_tr.eligible_by_ratio(j, 0.7))
    np.testing.assert_array_equal(t_tr.eligible_by_threshold(t),
                                  j_tr.eligible_by_threshold(j))


@pytest.mark.parametrize("selection,ratio", [("all", 1.0), ("ratio", 0.7),
                                             ("ratio", 0.0),
                                             ("threshold", 1.0)])
def test_eligible_mask_device_equal(selection, ratio):
    speeds = j_tr.sample_networks(np.random.default_rng(5), 40).upload_mbps
    j = j_tr.eligible_mask_device(jnp.asarray(speeds), selection,
                                  eligible_ratio=ratio)
    t = t_tr.eligible_mask_device(
        torch.tensor(speeds, dtype=torch.float32), selection,
        eligible_ratio=ratio)
    assert t.dtype == torch.bool
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("iid", [False, True])
def test_generate_synthetic_equal(iid):
    j = j_syn.generate_synthetic(np.random.default_rng(11), n_clients=12,
                                 iid=iid)
    t = t_syn.generate_synthetic(np.random.default_rng(11), n_clients=12,
                                 iid=iid)
    for name in ("train_x", "train_y", "test_x", "test_y"):
        for a, b in zip(getattr(t, name), getattr(j, name)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_stage_and_eval_set_equal():
    j = j_syn.generate_synthetic(np.random.default_rng(2), n_clients=9)
    t = t_syn.generate_synthetic(np.random.default_rng(2), n_clients=9)
    jd = j_syn.stage_on_device(j)
    td = t_syn.stage_on_device(t, "cpu")
    assert td.n_clients == jd.n_clients
    for name in ("train_x", "train_y", "counts"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    for a, b in zip(t_syn.padded_eval_set(t), j_syn.padded_eval_set(j)):
        np.testing.assert_array_equal(a, b)
    ids = np.array([0, 4, 8])
    for a, b in zip(
            t_syn.sample_batches(np.random.default_rng(1), t, ids, 3, 5),
            j_syn.sample_batches(np.random.default_rng(1), j, ids, 3, 5)):
        np.testing.assert_array_equal(a, b)
