"""The LMCC cascade's kernels: CUDA wrappers, plain versions, counters.

Six passes over one layer's edges (u, v int32 [m], bool masks [m]) or the
nodes (bool covered [n], int32 labels [n]); env/device_cascade.py strings
them into a cascade.  csrc/cascade.cu holds the kernels and says what bounds
them; they replace no TPU kernel (the JAX package's cascade is host C++).

  cover(covered, acts)                    covered[a] = True, a in [0, n)
  live_edges(u, v, sever, covered, alive, count)
                                          alive = ~sever & ~covered[u] &
                                          ~covered[v]; count[0] = Σ alive
  components(u, v, alive, label, touched) label[x] = the least node id of
                                          x's component over the live edges
                                          (x itself with no live edge);
                                          touched[x] = x has a live edge
  sever_test(u, v, alive, sever, label, touched, new_ids, count)
                                          live edges with label[u] !=
                                          label[v] or ~touched[u] (a node
                                          with no live edge there shares a
                                          component with nothing, itself
                                          included): severed, no longer
                                          alive, their ids appended to
                                          new_ids at count[0], which grows
  rank(label, covered, scratch, out)      out[0] = the most uncovered nodes
                                          under one label (0: none uncovered)
  alive_nodes(u, v, alive, mask)          mask = the live edges' endpoints

Outputs are written in place: count and out are one-element int64 views
(the engine's counter tensor), so a cascade reads back one small tensor.
On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA tensor
it launches its kernel (built with nvcc for sm_90a at first use into the
package's _build/) or raises, and adds one to `launches["cc_" + name]`.  The sever
kernel appends in the order its warps reach the counter, the plain version
in ascending edge id: the set is the same, and the engine sorts it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from mdcommunity_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC, build_library

SRC = os.path.join(CSRC, "cascade.cu")
LIB = os.path.join(BUILD_DIR, "libmdc_cascade.so")

# launches on CUDA tensors, by "cc_" and the wrapper's name (its C entry is
# mdc_cc_<name>)
NAMES = ("cover", "live_edges", "components", "sever_test", "rank", "alive_nodes")
launches = {"cc_" + k: 0 for k in NAMES}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build(force: bool = False) -> str:
    """Compile csrc/cascade.cu for sm_90a if the library is missing or older
    than the source; returns the library path."""
    return build_library(SRC, LIB, force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, args in (
            ("mdc_cc_cover", [p, p, i, i, p]),
            ("mdc_cc_live_edges", [p, p, p, p, p, ll, p, p]),
            ("mdc_cc_components", [p, p, p, ll, p, p, i, p]),
            ("mdc_cc_sever_test", [p, p, p, p, ll, p, p, p, p, p]),
            ("mdc_cc_rank", [p, p, i, p, p, p]),
            ("mdc_cc_alive_nodes", [p, p, p, ll, p, i, p]),
        ):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = i, args
        _lib = lib
    return _lib


def _launch(name: str, *args) -> None:
    """Call the C entry mdc_cc_<name> with the tensors' pointers, on the
    first one's device and current stream; raise on a CUDA error, else count
    the launch."""
    dev = args[0].device
    argv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        rc = getattr(_load(), "mdc_cc_" + name)(*argv, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cascade kernel {name} failed to launch with CUDA error {rc}")
    launches["cc_" + name] += 1


_DTYPES = dict(u=torch.int32, v=torch.int32, label=torch.int32, scratch=torch.int32,
               new_ids=torch.int32, acts=torch.int64, count=torch.int64, out=torch.int64,
               covered=torch.bool, sever=torch.bool, alive=torch.bool, mask=torch.bool,
               touched=torch.bool)


def _on_cuda(**tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, after checking that each has its argument's
    dtype, is contiguous and shares the first one's device; False for CPU
    tensors; raises on another device."""
    dev = next(iter(tensors.values())).device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in tensors.items():
        if t.dtype != _DTYPES[name] or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: the cascade kernels take a contiguous "
                             f"{_DTYPES[name]} tensor on {dev}, got {t.dtype} on {t.device}")
    return True


# ------------------------------------------------------------ plain versions


def cover_plain(covered: torch.Tensor, acts: torch.Tensor) -> None:
    a = acts[(acts >= 0) & (acts < covered.numel())]
    covered[a] = True


def live_edges_plain(u, v, sever, covered, alive, count) -> None:
    torch.logical_not(sever, out=alive)
    alive &= ~covered[u.long()] & ~covered[v.long()]
    count.fill_(int(alive.sum()))


def components_plain(u: torch.Tensor, v: torch.Tensor, alive: torch.Tensor,
                     label: torch.Tensor, touched: torch.Tensor) -> None:
    """Hook and compress with tensor ops: every round hooks each live edge's
    larger root under the smaller one (scatter of the minimum) and jumps
    pointers to the roots, until no live edge joins two roots.  A label
    never exceeds its node's id, so a root is its component's least id."""
    n = label.numel()
    lab = torch.arange(n, dtype=torch.int64, device=label.device)
    a, b = u[alive].long(), v[alive].long()
    touched.zero_()
    touched[a] = True
    touched[b] = True
    while True:
        la, lb = lab[a], lab[b]
        differ = la != lb
        if not bool(differ.any()):
            break
        lo, hi = torch.minimum(la, lb)[differ], torch.maximum(la, lb)[differ]
        lab.scatter_reduce_(0, hi, lo, "amin")
        while True:
            jumped = lab[lab]
            if torch.equal(jumped, lab):
                break
            lab = jumped
    label.copy_(lab)


def sever_test_plain(u, v, alive, sever, label, touched, new_ids, count) -> None:
    cut = alive & ((label[u.long()] != label[v.long()]) | ~touched[u.long()])
    ids = torch.nonzero(cut).flatten()
    k0 = int(count[0])
    new_ids[k0:k0 + len(ids)] = ids.to(new_ids.dtype)
    sever |= cut
    alive &= ~cut
    count += len(ids)


def rank_plain(label, covered, scratch, out) -> None:
    lab = label[~covered].long()
    out.fill_(int(torch.bincount(lab, minlength=1).max()) if len(lab) else 0)


def alive_nodes_plain(u, v, alive, mask) -> None:
    mask.zero_()
    mask[u[alive].long()] = True
    mask[v[alive].long()] = True


# ------------------------------------------------------------------ wrappers


def cover(covered: torch.Tensor, acts: torch.Tensor) -> None:
    """covered (bool [n]) |= the actions (int64 [k]) that lie in [0, n)."""
    if not _on_cuda(covered=covered, acts=acts):
        return cover_plain(covered, acts)
    _launch("cover", covered, acts, acts.numel(), covered.numel())


def live_edges(u, v, sever, covered, alive, count) -> None:
    """alive (bool [m]) = ~sever & ~covered[u] & ~covered[v]; count (int64
    [1]) = its number of True entries."""
    if not _on_cuda(u=u, v=v, sever=sever, covered=covered, alive=alive,
                    count=count):
        return live_edges_plain(u, v, sever, covered, alive, count)
    _launch("live_edges", u, v, sever, covered, alive, u.numel(), count)


def components(u, v, alive, label, touched) -> None:
    """label (int32 [n]) = each node's component label over the live edges:
    its least node id; touched (bool [n]) = the nodes with a live edge."""
    if not _on_cuda(u=u, v=v, alive=alive, label=label, touched=touched):
        return components_plain(u, v, alive, label, touched)
    _launch("components", u, v, alive, u.numel(), label, touched, label.numel())


def sever_test(u, v, alive, sever, label, touched, new_ids, count) -> None:
    """Sever the live edges whose ends `label` and `touched` (the other
    layer's) put apart; their ids go to new_ids (int32 [m]) from count[0]
    on."""
    if not _on_cuda(u=u, v=v, alive=alive, sever=sever, label=label, touched=touched,
                    new_ids=new_ids, count=count):
        return sever_test_plain(u, v, alive, sever, label, touched, new_ids, count)
    _launch("sever_test", u, v, alive, sever, u.numel(), label, touched, new_ids, count)


def rank(label, covered, scratch, out) -> None:
    """out (int64 [1]) = the most uncovered nodes that share a label;
    scratch: int32 [n]."""
    if not _on_cuda(label=label, covered=covered, scratch=scratch, out=out):
        return rank_plain(label, covered, scratch, out)
    _launch("rank", label, covered, label.numel(), scratch, out)


def alive_nodes(u, v, alive, mask) -> None:
    """mask (bool [n]) = the nodes with a live edge in this layer."""
    if not _on_cuda(u=u, v=v, alive=alive, mask=mask):
        return alive_nodes_plain(u, v, alive, mask)
    _launch("alive_nodes", u, v, alive, u.numel(), mask, mask.numel())
