"""Shape-bucketing planner for the batched serving tier — port of
``dhqr_tpu/serve/buckets.py``.

Every request ``(m, n, dtype)`` is rounded up onto a small static lattice
of padded bucket shapes, so the number of distinct bucket programs (CUDA
graphs on the card, ``serve.cache``) grows as O(log^2) of the served
shape range, and every request of a bucket stacks into one dispatch of the
batched engine.

Padding is exact: a request ``A`` (m, n) sits in the bucket shape (M, N) as

    [[A, 0 ], [0, I_k], [0, 0]]        k = N - n,  rows m+k..M-1 zero

— orthogonal padding columns in rows of their own, which decouple from the
request's columns in R, plus zero rows, which change neither the normal
equations nor the reflectors. So the padded factorization holds the
request's as its leading ``[:m, :n]`` block and ``x[:n]`` is the request's
solution, exactly in exact arithmetic and to roundoff in floats. The row
count is planned with room for the identity block (``M >= m + (N - n)``).

The lattice functions are the JAX module's, copied: the same request
gives the same bucket, and so the same cache key, in both packages. The
alignment tiers (8 rows below 128, then 64, then 128 from 512 up) were
chosen for the TPU; they are kept for that parity, and are not measured
on the H100.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dhqr_tpu_torch.utils.config import ServeConfig
from dhqr_tpu_torch.utils.device import dtype_name


def _align_for(v: int) -> int:
    """Lattice snap granularity around ``v`` (see module docstring)."""
    if v < 128:
        return 8
    if v < 512:
        return 64
    return 128


def _snap_up(v: int) -> int:
    a = _align_for(v)
    return -(-v // a) * a


def bucket_dim(x: int, config: "ServeConfig | None" = None) -> int:
    """Round one request dimension UP onto the geometric lattice.

    The lattice is the UNSNAPPED geometric sequence
    ``min_dim * ratio^k``, each point snapped up to the alignment tier
    independently — snapping a point must not feed the next ratio step,
    or the 64/128-snap compounds with the ratio and tears ~2x holes in
    the ladder exactly where serving shapes live. With the default
    ``ratio = sqrt(2)`` the snapped lattice is the half-octave ladder
    ``..., 64, 96, 128, 192, 256, 384, 512, 768, ...`` — every power of
    two and its 3/2 midpoint — so the common request sizes land exactly
    and the worst-case padding overshoot stays ~sqrt(2) per dimension.
    """
    cfg = config or ServeConfig.from_env()
    if x < 1:
        raise ValueError(f"dimension must be positive, got {x}")
    raw = float(cfg.min_dim)
    v = _snap_up(cfg.min_dim)
    while v < x:
        raw *= cfg.ratio
        # The relative epsilon keeps float accumulation from pushing an
        # exact lattice point past itself (16 * sqrt(2)^2 computes as
        # 32.000000000000004; a bare ceil would turn the whole power-of-
        # two ladder into 33-40-65-72-...).
        nxt = _snap_up(int(math.ceil(raw * (1.0 - 1e-9))))
        # Snapping can swallow a ratio step at small dims; keep the
        # ladder strictly increasing either way.
        v = nxt if nxt > v else v + _align_for(v)
    return v


def bucket_batch(count: int, config: "ServeConfig | None" = None) -> int:
    """Batch-axis bucket: next power of two >= count, capped at
    ``config.max_batch`` (groups beyond the cap are chunked by the
    engine, so a request burst can't mint an unbounded family of batch
    shapes)."""
    cfg = config or ServeConfig.from_env()
    if count < 1:
        raise ValueError(f"batch count must be positive, got {count}")
    # min() with the cap even on the pow2 branch: a non-power-of-two
    # max_batch (48, say) must still bound the stacked buffer — 33
    # requests round to 64 by the pow2 rule but dispatch at 48.
    return min(1 << (count - 1).bit_length(), cfg.max_batch)


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One padded bucket shape: requests mapped here stack into a
    ``(batch, m, n)`` dispatch of dtype ``dtype`` (a canonical numpy
    dtype name — part of the cache key)."""

    m: int
    n: int
    dtype: str

    @property
    def label(self) -> str:
        """The one display spelling (``"192x64:float32"``) shared by the
        scheduler's ``bucket_ewma_ms`` keys, the obs spans' ``bucket``
        attribute, and the dump/runbook prose — span-to-ewma correlation
        depends on every surface printing buckets identically."""
        return f"{self.m}x{self.n}:{self.dtype}"


def plan_bucket(m: int, n: int, dtype,
                config: "ServeConfig | None" = None) -> Bucket:
    """Map a raw request shape onto its bucket.

    ``n`` is rounded up first; ``m`` is then rounded with the identity
    block's ``k = N - n`` extra rows already included, so the exact
    embedding (module docstring) always fits: ``M >= m + k``.
    """
    cfg = config or ServeConfig.from_env()
    if n < 1 or m < n:
        raise ValueError(
            f"the serving tier factors tall problems (m >= n >= 1), "
            f"got shape ({m}, {n})"
        )
    N = bucket_dim(n, cfg)
    M = bucket_dim(m + (N - n), cfg)
    return Bucket(M, N, dtype_name(dtype))


def pad_group(requests, bucket: Bucket, batch: int, device=None):
    """Stack a bucket group into the buffers of one dispatch on ``device``.

    ``requests``: list of ``(A, b)`` pairs (numpy arrays or tensors; ``b``
    may be None for factor-only groups). Returns ``(A_buf, b_buf)``
    tensors of shapes ``(batch, M, N)`` / ``(batch, M)`` on ``device``
    (``b_buf`` is None when every ``b`` is). Each request is embedded
    exactly (module docstring); batch rows beyond ``len(requests)`` hold
    the identity embedding of an empty request, which factors trivially
    and keeps the back-substitution finite (an all-zero filler would put
    zeros on R's diagonal and NaNs in the padded lanes).

    Requests that arrive as host (numpy) arrays are stacked in host memory
    and cross to the device in one copy per buffer; a group holding
    tensors is stacked on the device, each tensor copied in place.
    """
    dev = torch.device("cpu" if device is None else device)
    M, N = bucket.m, bucket.n
    np_dtype = np.dtype(bucket.dtype)
    have_b = any(b is not None for _, b in requests)
    if not any(isinstance(x, torch.Tensor) for pair in requests
               for x in pair):
        A_np = np.zeros((batch, M, N), dtype=np_dtype)
        b_np = np.zeros((batch, M), dtype=np_dtype)
        for i, (A, b) in enumerate(requests):
            m, n = np.shape(A)
            A_np[i, :m, :n] = A
            if N - n:
                A_np[i, m:m + N - n, n:] = np.eye(N - n, dtype=np_dtype)
            if b is not None:
                b_np[i, :m] = b
        for i in range(len(requests), batch):
            A_np[i, :N, :N] = np.eye(N, dtype=np_dtype)
        A_buf = torch.from_numpy(A_np).to(dev)
        return A_buf, (torch.from_numpy(b_np).to(dev) if have_b else None)
    dtype = torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype
    A_buf = torch.zeros((batch, M, N), dtype=dtype, device=dev)
    b_buf = torch.zeros((batch, M), dtype=dtype, device=dev) if have_b \
        else None
    eye = torch.eye(N, dtype=dtype, device=dev)
    for i, (A, b) in enumerate(requests):
        A = torch.as_tensor(A)
        m, n = A.shape
        A_buf[i, :m, :n] = A
        if N - n:
            A_buf[i, m:m + N - n, n:] = eye[:N - n, :N - n]
        if b is not None:
            b_buf[i, :m] = torch.as_tensor(b)
    for i in range(len(requests), batch):
        A_buf[i, :N, :N] = eye
    return A_buf, b_buf
