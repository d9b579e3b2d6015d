"""ctypes bindings for the native host engine (src/mdc_native.cpp).

`load()` builds the shared library into the port's _build/ directory on
first use and returns None when no toolchain is available.
`NativeDuplexEnv` has the same surface as env/host_env.HostDuplexEnv and is
the engine of the large-graph eval path; `gmm_connect` is the GMM
generator's pair sampler for large N (graphs/gmm.py); the `mdc_louvain_*`
entries (src/mdc_louvain.cpp) run graphs/louvain.py's levels.

`NativeDuplexEnv.to(cuda device)` moves the env's cascade onto the card, in
place (env/device_cascade.DeviceCascade, csrc/cascade.cu): the banded loops
call it with their band's device.  An env that is never moved runs the C++
engine.

Every cascade (reset, step, step_many) records its work and time;
`NativeDuplexEnv.cascade_stats` reads the last one's as a dict keyed by
CASCADE_STATS.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

_lib = None
_load_attempted = False

# The engine's counters of one cascade, in mdc_env_cascade_stats's order:
# rounds of the alternating loop; records relabelled; nodes and edges their
# relabels walked; nodes that changed record; the other layer's incident
# edges tested for a sever; edges severed; ns seeding (covering the step's
# nodes, or reset's seed records), relabelling, testing severs, scanning
# for the rank.  Then on_device: 1 for a cascade the card ran
# (env/device_cascade.py gives the others their device meaning), 0 here.
CASCADE_STATS = ("rounds", "records_relabelled", "nodes_walked", "edges_walked",
                 "nodes_moved", "edges_tested", "edges_severed",
                 "cover_ns", "relabel_ns", "sever_test_ns", "rank_ns", "on_device")


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    try:
        from mdcommunity_tpu_torch.native.build import build

        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError) as exc:  # no g++ or load failure
        warnings.warn(f"mdc_native unavailable ({exc})")
        return None

    i64, i32, u32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32, ctypes.c_double
    p = ctypes.c_void_p
    lib.mdc_env_create.restype = p
    lib.mdc_env_create.argtypes = [i64, p, i64, p, i64, p]
    lib.mdc_env_destroy.argtypes = [p]
    lib.mdc_env_reset.argtypes = [p]
    lib.mdc_env_step.restype = i64
    lib.mdc_env_step.argtypes = [p, i64, i32]
    lib.mdc_env_step_many.restype = i64
    lib.mdc_env_step_many.argtypes = [p, p, i64, i32]
    for name in ("mdc_env_rank", "mdc_env_max_rank", "mdc_env_t",
                 "mdc_env_curve_len"):
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = [p]
    lib.mdc_env_score.restype = f64
    lib.mdc_env_score.argtypes = [p]
    lib.mdc_env_terminal.restype = i32
    lib.mdc_env_terminal.argtypes = [p]
    lib.mdc_env_curve.argtypes = [p, p]
    lib.mdc_env_new_sever_count.restype = i64
    lib.mdc_env_new_sever_count.argtypes = [p, i32]
    lib.mdc_env_new_sever.argtypes = [p, i32, p]
    lib.mdc_env_alive_nodes.argtypes = [p, i32, p]
    lib.mdc_env_sever_mask.argtypes = [p, i32, p]
    lib.mdc_env_set_uf_epoch.argtypes = [p, u32]
    lib.mdc_env_cascade_stats.restype = i64
    lib.mdc_env_cascade_stats.argtypes = [p, p]
    lib.mdc_gmm_connect.restype = i64
    lib.mdc_gmm_connect.argtypes = [i64, p, p, f64, f64, ctypes.c_uint64, p, i64]
    lib.mdc_louvain_create.restype = p
    lib.mdc_louvain_create.argtypes = [i64, p, i64, f64]
    lib.mdc_louvain_destroy.argtypes = [p]
    for name in ("mdc_louvain_empty", "mdc_louvain_level", "mdc_louvain_next"):
        getattr(lib, name).restype = i32
    lib.mdc_louvain_empty.argtypes = [p]
    lib.mdc_louvain_level.argtypes = [p, p]
    lib.mdc_louvain_next.argtypes = [p, f64]
    lib.mdc_louvain_size.restype = i64
    lib.mdc_louvain_size.argtypes = [p]
    lib.mdc_louvain_labels.restype = i64
    lib.mdc_louvain_labels.argtypes = [p, p]
    lib.mdc_louvain_stats.argtypes = [p, p]
    _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeDuplexEnv:
    """Union-find duplex dismantling env; same surface as HostDuplexEnv.
    After to(cuda) its DeviceCascade serves the surface."""

    engine = "native"

    def __init__(
        self,
        n: int,
        edges0: np.ndarray,
        edges1: np.ndarray,
        weights: Optional[np.ndarray] = None,
    ):
        lib = load()
        if lib is None:
            raise RuntimeError("native engine unavailable")
        self._lib = lib
        self.n = int(n)
        e0 = np.ascontiguousarray(np.asarray(edges0, np.int64).reshape(-1, 2))
        e1 = np.ascontiguousarray(np.asarray(edges1, np.int64).reshape(-1, 2))
        w = (
            np.ascontiguousarray(np.asarray(weights, np.float64).reshape(2, n))
            if weights is not None
            else None
        )
        self._handle = lib.mdc_env_create(
            self.n, _ptr(e0), len(e0), _ptr(e1), len(e1),
            _ptr(w) if w is not None else None,
        )
        self.edges = [e0, e1]  # C++ keeps its own copy; these are for callers
        self.weights = w
        self.covered = np.zeros(self.n, bool)
        self.max_rank = int(lib.mdc_env_max_rank(self._handle))
        self._dev = None  # the DeviceCascade once engaged

    def to(self, device) -> "NativeDuplexEnv":
        """Run the cascade on `device` from now on, in place: a CUDA device
        engages a DeviceCascade (engage); the CPU keeps the C++ engine.
        Returns the env."""
        import torch

        if torch.device(device).type == "cuda":
            self.engage(device)
        return self

    def engage(self, device) -> "NativeDuplexEnv":
        """Copy the C++ engine's state (covered, sever masks, rank, score,
        curve, t) into a DeviceCascade on `device`, which then serves step,
        step_many, reset, rank, terminal, sever, alive_nodes and
        cascade_stats; on a CPU device it runs the kernels' plain versions
        (the tests' way in).  Engaging the device already engaged does
        nothing; another raises."""
        import torch

        from mdcommunity_tpu_torch.env.device_cascade import DeviceCascade

        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if self._dev is None:
            self._dev = DeviceCascade(self, dev)
        elif self._dev.device != dev:
            raise ValueError(f"the env's cascade is on {self._dev.device}, not {dev}")
        return self

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.mdc_env_destroy(h)
            self._handle = None

    @property
    def rank(self) -> int:
        if self._dev is not None:
            return self._dev.rank
        return int(self._lib.mdc_env_rank(self._handle))

    @property
    def score(self) -> float:
        if self._dev is not None:
            return self._dev.score
        return float(self._lib.mdc_env_score(self._handle))

    @property
    def t(self) -> int:
        if self._dev is not None:
            return self._dev.t
        return int(self._lib.mdc_env_t(self._handle))

    @property
    def terminal(self) -> bool:
        if self._dev is not None:
            return self._dev.terminal
        return bool(self._lib.mdc_env_terminal(self._handle))

    @property
    def curve(self) -> List[float]:
        if self._dev is not None:
            return list(self._dev.curve)
        k = int(self._lib.mdc_env_curve_len(self._handle))
        out = np.empty(k, np.float64)
        self._lib.mdc_env_curve(self._handle, _ptr(out))
        return out.tolist()

    @property
    def sever(self) -> List[np.ndarray]:
        if self._dev is not None:
            return self._dev.sever_masks
        out = []
        for layer in (0, 1):
            buf = np.zeros(len(self.edges[layer]), np.uint8)
            if len(buf):
                self._lib.mdc_env_sever_mask(self._handle, layer, _ptr(buf))
            out.append(buf.astype(bool))
        return out

    def reset(self):
        if self._dev is not None:
            return self._dev.reset()
        self._lib.mdc_env_reset(self._handle)
        self.covered[:] = False

    def step(self, a: int, degree_cost: bool = False) -> Tuple[int, List[np.ndarray]]:
        assert not self.covered[a], a
        if self._dev is not None:
            return self._dev.step(a, degree_cost)
        rank = int(self._lib.mdc_env_step(self._handle, int(a), int(degree_cost)))
        self.covered[a] = True
        return rank, self._new_sever()

    def step_many(
        self, actions: np.ndarray, degree_cost: bool = False
    ) -> Tuple[int, List[np.ndarray], int]:
        """Batched removal with ONE cascade.  The final covered/rank/terminal
        state and the sever mask over live-relevant edges equal sequential
        stepping (the MCC fixed point after removing a set is
        order-independent); curve and score take the post-batch rank for
        every node of the batch (AUDC bias ≤ batch/n).  Skips covered
        entries.  Returns (rank, new severed edges per layer, n_removed)."""
        if self._dev is not None:
            return self._dev.step_many(actions, degree_cost)
        acts = np.ascontiguousarray(np.asarray(actions, np.int64).reshape(-1))
        removed = int(
            self._lib.mdc_env_step_many(
                self._handle, _ptr(acts), len(acts), int(degree_cost)
            )
        )
        valid = (acts >= 0) & (acts < self.n)
        self.covered[acts[valid]] = True
        return self.rank, self._new_sever(), removed

    def _new_sever(self) -> List[np.ndarray]:
        out = []
        for layer in (0, 1):
            k = int(self._lib.mdc_env_new_sever_count(self._handle, layer))
            buf = np.zeros((k, 2), np.int64)
            if k:
                self._lib.mdc_env_new_sever(self._handle, layer, _ptr(buf))
            out.append(buf)
        return out

    @property
    def cascade_stats(self) -> Dict[str, int]:
        """The last cascade's counters (CASCADE_STATS); a step_many that
        removed nothing ran none and leaves them as they were."""
        if self._dev is not None:
            return dict(self._dev.stats)
        out = np.zeros(len(CASCADE_STATS), np.int64)
        got = self._lib.mdc_env_cascade_stats(self._handle, _ptr(out))
        assert got == len(CASCADE_STATS) - 1, got
        return dict(zip(CASCADE_STATS, out.tolist() + [0]))

    def alive_nodes(self, layer: int) -> np.ndarray:
        """bool [n]: nodes with at least one live edge in `layer`."""
        if self._dev is not None:
            return self._dev.alive_nodes(layer)
        out = np.zeros(self.n, np.uint8)
        self._lib.mdc_env_alive_nodes(self._handle, int(layer), _ptr(out))
        return out.astype(bool)

    def set_uf_epoch(self, epoch: int) -> None:
        """Move the relabel union-find's epoch counter (a test hook: set it
        near 2^32 to drive the counter through its wrap)."""
        self._lib.mdc_env_set_uf_epoch(self._handle, int(epoch))


def gmm_connect(
    kappa: np.ndarray, theta: np.ndarray, T: float, mu: float, seed: int
) -> Optional[np.ndarray]:
    """Native pairwise Fermi-Dirac connector (the JAX package's
    native.gmm_connect, same stream for the same seed): undirected edges
    [M, 2] int32, or None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(kappa)
    kappa = np.ascontiguousarray(kappa, np.float64)
    theta = np.ascontiguousarray(theta, np.float64)
    cap = max(4 * n, 1024)
    while True:
        out = np.empty((cap, 2), np.int32)
        cnt = lib.mdc_gmm_connect(n, _ptr(kappa), _ptr(theta), float(T), float(mu),
                                  np.uint64(seed), _ptr(out), cap)
        if cnt >= 0:
            return np.ascontiguousarray(out[:cnt])
        cap *= 4
