"""The one load generator: a traffic file of ``traffic/`` names its request,
its inputs and its loop, and this module drives the system with it.

Keys of a traffic file:
  request   the module of ``requests/`` that serves and judges a request:
            "solve" (PCG to the configuration's tolerance), "vmult" (one
            application of the preconditioner);
  loop      "closed": one client sends the next request when the last one
            has returned; "open": requests arrive at ``rate_per_s`` a
            second, at exponential gaps drawn from the seed, and wait for
            the one server, each timed from its arrival;
  clients   1 (a closed loop's);
  pool      the number of inputs drawn from the seed and cycled through;
  input     "uniform": entries uniform in [0, 1), zero at the Dirichlet dofs
            (what the request module makes of them is its own);
  maxiter   the PCG iteration cap of a "solve";
  warmup    requests sent in set-up, before the window;
  sample    answers kept from the window for the check, drawn from the
            seed, as many of each pool row (sample / pool, rounded up);
  trace_requests  requests in the profiled stretch of a traced run.
"""

from __future__ import annotations

import dataclasses
import random
import time

import numpy as np
import torch

INPUTS = ("uniform",)


def check_traffic(traffic: dict) -> None:
    if traffic["loop"] == "closed":
        if traffic["clients"] != 1:
            raise ValueError("a closed loop is generated for one client")
    elif traffic["loop"] == "open":
        if not traffic["rate_per_s"] > 0:
            raise ValueError("an open loop needs rate_per_s > 0")
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    if traffic["input"] not in INPUTS:
        raise ValueError(f"unknown input {traffic['input']!r}")


def uniform(rows: int, n: int, constrained, seed: int, device,
            dtype) -> torch.Tensor:
    """(rows, n) entries uniform in [0, 1) from ``seed``, made on ``device``
    in one call, zero at the ``constrained`` dofs."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    pool = torch.rand((rows, n), generator=g, device=device, dtype=dtype)
    pool[:, torch.as_tensor(np.asarray(constrained), device=device)] = 0.0
    return pool


@dataclasses.dataclass
class Window:
    """What a window of requests gave: per-request wall seconds and
    counters, its length, and the kept answers as (request index, pool
    index, answer)."""
    seconds: float
    latencies: list
    counters: list
    sample: list

    @property
    def completed(self) -> int:
        return len(self.latencies)


def run(traffic: dict, fn, pool: torch.Tensor, seconds: float,
        seed: int) -> Window:
    """The traffic's loop over ``seconds``: requests fn(pool[j]) -> (answer,
    counters) over the pool in turn.  The window closes when the last
    request that arrived before ``seconds`` had passed returns, and lasts
    ``seconds`` at least.  The kept answers are, for each pool row, a
    uniform sample (a reservoir, from ``seed``) of that row's answers."""
    rng = random.Random(int(seed))
    arrivals = random.Random(int(seed) + 1)
    gap = (lambda: arrivals.expovariate(traffic["rate_per_s"])) \
        if traffic["loop"] == "open" else None
    n_pool = pool.shape[0]
    per_row = -(-traffic["sample"] // n_pool)
    lat, ctrs = [], []
    kept, seen = [[] for _ in range(n_pool)], [0] * n_pool
    start = time.perf_counter()
    deadline = start + seconds
    end = arrive = start
    i = 0
    while arrive < deadline:
        if gap is not None:
            while time.perf_counter() < arrive:
                pass
        j = i % n_pool
        out, ctr = fn(pool[j])
        end = time.perf_counter()
        lat.append(end - arrive)
        ctrs.append(ctr)
        seen[j] += 1
        if len(kept[j]) < per_row:
            kept[j].append((i, j, out))
        else:
            k = rng.randrange(seen[j])
            if k < per_row:
                kept[j][k] = (i, j, out)
        i += 1
        arrive = end if gap is None else arrive + gap()
    return Window(max(end, deadline) - start, lat, ctrs,
                  [k for row in kept for k in row])


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation, numpy's default."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
