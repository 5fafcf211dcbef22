"""Synthetic(alpha, beta) federated dataset — the q-FedAvg / FedProx
recipe the paper uses for all its tables and figures (§3.2).

Per device k:
    u_k ~ N(0, alpha);  W_k[i,j] ~ N(u_k, 1),  b_k[i] ~ N(u_k, 1)
    B_k ~ N(0, beta);   v_k[j] ~ N(B_k, 1)
    Sigma = diag(j^-1.2);  x ~ N(v_k, Sigma)
    y = argmax(W_k x + b_k)
    n_k ~ LogNormal(4, 2) + 50   (power-law sample counts)

iid variant: one shared (W, b) and v_k = 0 for every device. Generation
is numpy on the host; ``stage_on_device`` pads the train sets into
tensors on the round engine's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

D_FEAT = 60
N_CLASSES = 10


class DeviceDataset(NamedTuple):
    """Every client's train set zero-padded to a common length, so a
    round gathers fixed-shape minibatches with per-client bounds. A
    named tuple, so ``torch.func.vmap`` can map over a stacked one."""
    train_x: torch.Tensor   # ([S,] N, M, D_FEAT) float32
    train_y: torch.Tensor   # ([S,] N, M) int32
    counts: torch.Tensor    # ([S,] N) int32 true samples per client

    @property
    def n_clients(self) -> int:
        return int(self.counts.shape[-1])


@dataclasses.dataclass
class FederatedDataset:
    train_x: List[np.ndarray]
    train_y: List[np.ndarray]
    test_x: List[np.ndarray]
    test_y: List[np.ndarray]

    @property
    def n_clients(self) -> int:
        return len(self.train_x)

    @property
    def samples_per_client(self) -> np.ndarray:
        return np.array([len(x) for x in self.train_x])


def stage_on_device(data: FederatedDataset, device) -> DeviceDataset:
    """Pad per-client train sets to the longest and move them to
    ``device`` once per run. Batch indices are drawn in [0, counts[k]),
    so the padding is never sampled."""
    N = data.n_clients
    counts = data.samples_per_client
    M = int(counts.max())
    X = np.zeros((N, M, D_FEAT), np.float32)
    Y = np.zeros((N, M), np.int32)
    for k in range(N):
        n = counts[k]
        X[k, :n] = data.train_x[k]
        Y[k, :n] = data.train_y[k]
    return DeviceDataset(torch.from_numpy(X).to(device),
                         torch.from_numpy(Y).to(device),
                         torch.from_numpy(counts.astype(np.int32)).to(device))


def stage_scenarios_on_device(datasets: Sequence[FederatedDataset],
                              device) -> DeviceDataset:
    """S scenarios' datasets stacked behind a leading scenario axis on
    ``device``, for the sweep engine: train_x (S, N, M, D_FEAT), train_y
    (S, N, M), counts (S, N). All hold N clients; sets are padded to
    the longest across all scenarios. Padding is never sampled, so each
    scenario computes what its own staging would."""
    if not datasets:
        raise ValueError("no scenario datasets")
    n_set = {d.n_clients for d in datasets}
    if len(n_set) != 1:
        raise ValueError(f"scenario client counts differ: {sorted(n_set)}")
    N = n_set.pop()
    S = len(datasets)
    M = max(int(d.samples_per_client.max()) for d in datasets)
    X = np.zeros((S, N, M, D_FEAT), np.float32)
    Y = np.zeros((S, N, M), np.int32)
    counts = np.zeros((S, N), np.int32)
    for s, d in enumerate(datasets):
        for k in range(N):
            n = len(d.train_x[k])
            X[s, k, :n] = d.train_x[k]
            Y[s, k, :n] = d.train_y[k]
            counts[s, k] = n
    return DeviceDataset(torch.from_numpy(X).to(device),
                         torch.from_numpy(Y).to(device),
                         torch.from_numpy(counts).to(device))


def generate_synthetic(rng: np.random.Generator, n_clients: int = 30,
                       alpha: float = 1.0, beta: float = 1.0,
                       iid: bool = False, max_samples: int = 1000,
                       test_frac: float = 0.2) -> FederatedDataset:
    diag = np.array([(j + 1) ** -1.2 for j in range(D_FEAT)])
    n_k = (rng.lognormal(4.0, 2.0, n_clients).astype(int) + 50
           ).clip(50, max_samples)

    if iid:
        W = rng.normal(0, 1, (N_CLASSES, D_FEAT))
        b = rng.normal(0, 1, N_CLASSES)

    tx, ty, sx, sy = [], [], [], []
    for k in range(n_clients):
        if not iid:
            u = rng.normal(0, np.sqrt(alpha))
            W = rng.normal(u, 1, (N_CLASSES, D_FEAT))
            b = rng.normal(u, 1, N_CLASSES)
            Bk = rng.normal(0, np.sqrt(beta))
            v = rng.normal(Bk, 1, D_FEAT)
        else:
            v = np.zeros(D_FEAT)
        x = rng.normal(v, np.sqrt(diag), (n_k[k], D_FEAT)).astype(np.float32)
        y = np.argmax(x @ W.T + b, axis=1).astype(np.int32)
        n_test = max(1, int(test_frac * n_k[k]))
        tx.append(x[n_test:])
        ty.append(y[n_test:])
        sx.append(x[:n_test])
        sy.append(y[:n_test])
    return FederatedDataset(tx, ty, sx, sy)


def sample_batches(rng: np.random.Generator, data: FederatedDataset,
                   client_ids: np.ndarray, n_steps: int, batch_size: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-shape minibatches for vmapped local training:
    (X (C, n_steps, bs, D), Y (C, n_steps, bs))."""
    C = len(client_ids)
    X = np.empty((C, n_steps, batch_size, D_FEAT), np.float32)
    Y = np.empty((C, n_steps, batch_size), np.int32)
    for i, k in enumerate(client_ids):
        n = len(data.train_x[k])
        idx = rng.integers(0, n, (n_steps, batch_size))
        X[i] = data.train_x[k][idx]
        Y[i] = data.train_y[k][idx]
    return X, Y


def padded_eval_set(data: FederatedDataset):
    """Per-client test sets padded to equal length with a validity mask:
    (X (N, M, D), Y (N, M), mask (N, M)) numpy arrays."""
    N = data.n_clients
    M = max(len(x) for x in data.test_x)
    X = np.zeros((N, M, D_FEAT), np.float32)
    Y = np.zeros((N, M), np.int32)
    W = np.zeros((N, M), np.float32)
    for k in range(N):
        m = len(data.test_x[k])
        X[k, :m] = data.test_x[k]
        Y[k, :m] = data.test_y[k]
        W[k, :m] = 1.0
    return X, Y, W
