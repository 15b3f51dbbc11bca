"""The discrete-event simulator's lanes: CUDA kernels and plain versions.

Counterparts of the JAX package's four vmapped ``lax.scan`` lanes of
``repro.queueing_sim`` (none of them a Pallas kernel); the CUDA source is
``csrc/des_scan.cu``. Each lane is a sequential recursion over one
stream's queries (or attempt events), batched across streams:

* :func:`lindley` — FIFO M/G/1, ``start = max(a_i, fin)``,
  ``fin = start + s_i`` (``batched.py:85``);
* :func:`free_server` — FIFO M/G/c over a ``[c_max]`` free-time panel,
  absent servers at +inf (``multiserver.py:115``);
* :func:`windowed` — the masked-argmin pass over a sliding window of
  ``W`` candidate slots, for any priority keys (``disciplines.py:376``);
* :func:`impatience_pass` — the reneging / retry event pass over stably
  sorted attempt events (``impatience.py:255``).

Every tensor is float64 (event indices int64) and row-major ``[streams,
...]``. The plain versions loop over queries in Python, vectorised across
streams, and repeat the scan bodies operation for operation, so they are
bitwise equal to the JAX lanes and to the kernels. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _cuda

F64 = torch.float64
#: servers a free-time panel takes (csrc/des_scan.cu kMaxC)
MAX_C = 8
#: candidate window the argmin kernel takes (csrc/des_scan.cu kMaxWindow)
MAX_WINDOW = 512

_LL = ctypes.c_longlong
_D = ctypes.c_double


def _check(name: str, tensors: dict) -> torch.device:
    """Raise unless every tensor lies on one CUDA device, contiguous, in
    its stated dtype."""
    first = next(iter(tensors.values()))[0]
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    for arg, (t, dtype) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev


# -------------------------------------------------------------- Lindley
def lindley_plain(arrivals, services):
    """``[B, n] -> (start, finish)``: the scan of ``lindley_jax``."""
    B, n = arrivals.shape
    start = torch.empty_like(arrivals)
    finish = torch.empty_like(arrivals)
    fin = torch.zeros(B, dtype=F64, device=arrivals.device)
    for i in range(n):
        st = torch.maximum(arrivals[:, i], fin)
        fin = st + services[:, i]
        start[:, i] = st
        finish[:, i] = fin
    return start, finish


def lindley(arrivals, services):
    """FIFO start/finish times of ``[B, n]`` streams."""
    if arrivals.device.type == "cpu":
        return lindley_plain(arrivals, services)
    name = "des_lindley"
    dev = _check(name, {"arrivals": (arrivals, F64),
                        "services": (services, F64)})
    if services.shape != arrivals.shape or arrivals.dim() != 2:
        raise ValueError(f"{name}: arrivals {tuple(arrivals.shape)} and "
                         f"services {tuple(services.shape)} must be one "
                         "[B, n] shape")
    B, n = arrivals.shape
    start = torch.empty_like(arrivals)
    finish = torch.empty_like(arrivals)
    if B * n == 0:
        return start, finish
    fn = _cuda.entry("des_scan", name, [_cuda.P] * 4 + [_LL, _LL, _cuda.P])
    err = fn(arrivals.data_ptr(), services.data_ptr(), start.data_ptr(),
             finish.data_ptr(), B, n, _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return start, finish


# ---------------------------------------------------------- free server
def free_server_plain(arrivals, services, free0):
    """``[B, n]`` streams, ``[B, c_max]`` initial free times -> (start,
    finish): the scan of ``free_server_jax`` (first earliest-free server)."""
    B, n = arrivals.shape
    free = free0.clone()
    rows = torch.arange(B, device=arrivals.device)
    start = torch.empty_like(arrivals)
    finish = torch.empty_like(arrivals)
    for i in range(n):
        j = torch.argmin(free, dim=1)
        st = torch.maximum(arrivals[:, i], free[rows, j])
        fi = st + services[:, i]
        free[rows, j] = fi
        start[:, i] = st
        finish[:, i] = fi
    return start, finish


def free_server(arrivals, services, free0):
    """FIFO M/G/c start/finish times; ``free0`` holds +inf for absent
    servers. At most :data:`MAX_C` servers on the card."""
    if arrivals.device.type == "cpu":
        return free_server_plain(arrivals, services, free0)
    name = "des_free_server"
    dev = _check(name, {"arrivals": (arrivals, F64),
                        "services": (services, F64), "free0": (free0, F64)})
    B, n = arrivals.shape
    if services.shape != arrivals.shape or free0.shape[0] != B:
        raise ValueError(f"{name}: shapes {tuple(arrivals.shape)}, "
                         f"{tuple(services.shape)}, {tuple(free0.shape)}")
    c_max = free0.shape[1]
    if not 1 <= c_max <= MAX_C:
        raise ValueError(f"{name}: {c_max} servers not supported "
                         f"(1..{MAX_C})")
    start = torch.empty_like(arrivals)
    finish = torch.empty_like(arrivals)
    if B * n == 0:
        return start, finish
    fn = _cuda.entry("des_scan", name,
                     [_cuda.P] * 5 + [_LL, _LL, _cuda.I, _cuda.P])
    err = fn(arrivals.data_ptr(), services.data_ptr(), free0.data_ptr(),
             start.data_ptr(), finish.data_ptr(), B, n, c_max,
             _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return start, finish


# ------------------------------------------------------ windowed argmin
def windowed_plain(ap, sp, kp, window: int):
    """Padded ``[B, n + W]`` arrivals, services and keys -> (start [B, n],
    finish [B, n], overflow [B]): the scan body of ``_jax_kernel``."""
    W = int(window)
    B, nw = ap.shape
    n = nw - W
    dev = ap.device
    rows = torch.arange(B, device=dev)
    offs = torch.arange(W, device=dev)
    srv = torch.zeros(B, W, dtype=torch.bool, device=dev)
    lo = torch.zeros(B, dtype=torch.long, device=dev)
    free_t = torch.zeros(B, dtype=F64, device=dev)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    start = torch.zeros(B, n, dtype=F64, device=dev)
    finish = torch.zeros(B, n, dtype=F64, device=dev)
    inf = torch.tensor(torch.inf, dtype=F64, device=dev)
    for _ in range(n):
        idx = lo[:, None] + offs
        arr_w = ap.gather(1, idx)
        cand = ~srv & (arr_w <= free_t[:, None])
        # idle jump: window head is the earliest unserved query
        free_t = torch.where(cand.any(dim=1), free_t, arr_w[:, 0])
        cand = ~srv & (arr_w <= free_t[:, None])
        ovf = ovf | (ap[rows, lo + W] <= free_t)
        slot = torch.argmin(torch.where(cand, kp.gather(1, idx), inf), dim=1)
        qid = lo + slot
        fin = free_t + sp[rows, qid]
        srv[rows, slot] = True
        uns = ~srv
        adv = torch.where(uns.any(dim=1), torch.argmax(uns.to(torch.uint8),
                                                       dim=1), W)
        # slide the mask past the served prefix; revealed slots unserved
        shifted = offs + adv[:, None]
        srv = srv.gather(1, shifted.clamp(max=W - 1)) & (shifted < W)
        lo = lo + adv
        keep = qid < n
        start[rows[keep], qid[keep]] = free_t[keep]
        finish[rows[keep], qid[keep]] = fin[keep]
        free_t = fin
    return start, finish, ovf


def windowed(ap, sp, kp, window: int):
    """Masked-argmin start/finish and overflow flags of padded streams
    (``W`` slots of +inf arrival and key, 0 service, after each stream).
    At most :data:`MAX_WINDOW` slots on the card."""
    if ap.device.type == "cpu":
        return windowed_plain(ap, sp, kp, window)
    name = "des_windowed"
    dev = _check(name, {"ap": (ap, F64), "sp": (sp, F64), "kp": (kp, F64)})
    W = int(window)
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"{name}: window {W} not supported "
                         f"(1..{MAX_WINDOW})")
    if sp.shape != ap.shape or kp.shape != ap.shape or ap.shape[1] < W:
        raise ValueError(f"{name}: padded shapes {tuple(ap.shape)}, "
                         f"{tuple(sp.shape)}, {tuple(kp.shape)} with W {W}")
    B, nw = ap.shape
    n = nw - W
    start = torch.zeros(B, n, dtype=F64, device=dev)
    finish = torch.zeros(B, n, dtype=F64, device=dev)
    ovf = torch.zeros(B, dtype=torch.uint8, device=dev)
    if B * n == 0:
        return start, finish, ovf.bool()
    fn = _cuda.entry("des_scan", name,
                     [_cuda.P] * 6 + [_LL, _LL, _cuda.I, _cuda.P])
    err = fn(ap.data_ptr(), sp.data_ptr(), kp.data_ptr(), start.data_ptr(),
             finish.data_ptr(), ovf.data_ptr(), B, n, W,
             _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return start, finish, ovf.bool()


# ---------------------------------------------------------- impatience
def impatience_pass_plain(t_ev, i_ev, k_ev, services, tau: float,
                          kmax: int, c_servers: int, orphaned: bool):
    """Sorted attempt events ``[S, E]`` (time, customer, attempt) over
    ``[S, n]`` services -> (served, n_att, start, finish, wait), each
    ``[S, n]``: the scan body of ``_jax_event_pass``. ``tau``, ``kmax``
    and ``orphaned`` are scalars or per-stream ``[S]`` tensors, so streams
    of several retry policies can share one pass."""
    S, E = t_ev.shape
    n = services.shape[1]
    dev = t_ev.device
    rs = torch.arange(S, device=dev)
    free = torch.zeros(S, int(c_servers), dtype=F64, device=dev)
    served = torch.zeros(S, n, dtype=torch.bool, device=dev)
    nxt = torch.zeros(S, n, dtype=torch.long, device=dev)
    n_att = torch.zeros(S, n, dtype=torch.long, device=dev)
    start = torch.full((S, n), torch.nan, dtype=F64, device=dev)
    finish = torch.full((S, n), torch.nan, dtype=F64, device=dev)
    wait = torch.full((S, n), torch.nan, dtype=F64, device=dev)
    for e in range(E):
        t_e, i_e, k_e = t_ev[:, e], i_ev[:, e], k_ev[:, e]
        live = ~served[rs, i_e] & (nxt[rs, i_e] == k_e)
        am = torch.argmin(free, dim=1)
        f_am = free[rs, am]
        st = torch.maximum(t_e, f_am)
        ok = live & (st - t_e <= tau)
        timeout = live & ~ok
        occupy = ok | (timeout & orphaned)
        n_att[rs, i_e] = torch.where(live, k_e + 1, n_att[rs, i_e])
        fin = st + services[rs, i_e]
        served[rs, i_e] = served[rs, i_e] | ok
        start[rs, i_e] = torch.where(ok, st, start[rs, i_e])
        wait[rs, i_e] = torch.where(ok, st - t_e, wait[rs, i_e])
        finish[rs, i_e] = torch.where(ok, fin, finish[rs, i_e])
        free[rs, am] = torch.where(occupy, fin, f_am)
        nxt[rs, i_e] += (timeout & (k_e < kmax)).long()
    return served, n_att, start, finish, wait


def impatience_pass(t_ev, i_ev, k_ev, services, tau: float, kmax: int,
                    c_servers: int, orphaned: bool):
    """The impatience event pass; see :func:`impatience_pass_plain`. At
    most :data:`MAX_C` servers on the card."""
    if t_ev.device.type == "cpu":
        return impatience_pass_plain(t_ev, i_ev, k_ev, services, tau, kmax,
                                     c_servers, orphaned)
    name = "des_impatience"
    dev = _check(name, {"t_ev": (t_ev, F64), "i_ev": (i_ev, torch.long),
                        "k_ev": (k_ev, torch.long),
                        "services": (services, F64)})
    S, E = t_ev.shape
    n = services.shape[1]
    if i_ev.shape != t_ev.shape or k_ev.shape != t_ev.shape \
            or services.shape[0] != S:
        raise ValueError(f"{name}: events {tuple(t_ev.shape)}, "
                         f"{tuple(i_ev.shape)}, {tuple(k_ev.shape)} and "
                         f"services {tuple(services.shape)}")
    if not 1 <= c_servers <= MAX_C:
        raise ValueError(f"{name}: {c_servers} servers not supported "
                         f"(1..{MAX_C})")
    served = torch.zeros(S, n, dtype=torch.uint8, device=dev)
    nxt = torch.zeros(S, n, dtype=torch.long, device=dev)
    n_att = torch.zeros(S, n, dtype=torch.long, device=dev)
    start = torch.full((S, n), torch.nan, dtype=F64, device=dev)
    finish = torch.full((S, n), torch.nan, dtype=F64, device=dev)
    wait = torch.full((S, n), torch.nan, dtype=F64, device=dev)
    if S * E > 0:
        fn = _cuda.entry("des_scan", name,
                         [_cuda.P] * 10 + [_LL, _LL, _LL, _D, _LL, _cuda.I,
                                           _cuda.I, _cuda.P])
        err = fn(t_ev.data_ptr(), i_ev.data_ptr(), k_ev.data_ptr(),
                 services.data_ptr(), served.data_ptr(), nxt.data_ptr(),
                 n_att.data_ptr(), start.data_ptr(), finish.data_ptr(),
                 wait.data_ptr(), S, E, n, float(tau), int(kmax),
                 int(c_servers), int(bool(orphaned)), _cuda.stream_ptr(dev))
        _cuda.raise_on(name, err)
        LAUNCHES[name] += 1
    return served.bool(), n_att, start, finish, wait


def step_probe(out, a0: float, s: float, steps: int) -> None:
    """Walk one chain of ``steps`` dependent Lindley steps on the card into
    ``out`` (one float64 on a CUDA device): times the recursion's latency
    for the lanes' sequential floor. A measurement, not a lane: it counts
    no launch."""
    name = "des_step_probe"
    dev = _check(name, {"out": (out, F64)})
    fn = _cuda.entry("des_scan", name, [_cuda.P, _D, _D, _LL, _cuda.P])
    _cuda.raise_on(name, fn(out.data_ptr(), float(a0), float(s), int(steps),
                            _cuda.stream_ptr(dev)))
