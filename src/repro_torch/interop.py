"""Carry an index or LM parameters made by the JAX package across into
this port.

``index_from_numpy`` takes the reference index's fields as numpy arrays
(``np.asarray`` of each) and returns the port's ``GraphIndex`` — or, given
the RaBitQ fields too, ``EMQGIndex`` — on ``device``.  The ``uint32`` code
words become their ``int32`` view, bit for bit.

``index_to_numpy`` is the inverse: a port index as the keyword arguments of
``index_from_numpy``.  ``sharded_from_numpy`` takes a reference
``ShardedIndex``'s stacked leaves (each with a leading dim S) with its
``offsets``, ``n_total`` and ``sizes``, and returns the port's
``ShardedIndex``, one ``index_from_numpy`` a slot.

``lm_params_from_numpy`` takes the reference LM's parameter tree as numpy
arrays and returns the port's parameter dict on ``device``;
``lm_params_to_numpy`` is its inverse, for any tree of the parameters'
structure (gradients, AdamW moments, trained weights), so that a test
compares the two packages' trees leaf for leaf.  ``train_state_from_numpy``
carries a reference ``TrainState`` (its params, opt_state and step) across.

``recsys_params_from_numpy`` takes a reference recsys model's parameter
tree (FM, DCN-v2, DIEN or MIND: nested dicts, a 0-d ``bias``) as numpy
arrays and returns the port's on ``device``; ``recsys_params_to_numpy``
is its inverse.  ``gnn_params_from_numpy`` and ``gnn_params_to_numpy`` do
the same for the GAT's ``layer{i}/{w, a_src, a_dst, b}`` tree.

Nothing here imports the JAX package; the caller converts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.distributed import ShardedIndex
from .core.types import EMQGIndex, GraphIndex, RaBitQCodes, resolve_device
from .models import gnn
from .models import recsys as rs
from .models.transformer import _is_moe_layer
from .optim.adamw import tree_map


def index_from_numpy(vectors, neighbors, medoid, kind: str = "delta_emg",
                     delta: float = 0.0, codes=None, norms=None, ip_xo=None,
                     rotation=None, center=None, dim: Optional[int] = None,
                     device="cuda"):
    """GraphIndex from (vectors, neighbors, medoid, kind, delta); EMQGIndex
    when ``codes`` (uint32[n, W]) and the other RaBitQ fields are given."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev).contiguous()

    graph = GraphIndex(
        vectors=f32(vectors),
        neighbors=torch.from_numpy(np.array(neighbors, np.int32)).to(dev),
        medoid=int(np.asarray(medoid)), kind=kind, delta=float(delta))
    if codes is None:
        return graph
    words = np.array(codes, np.uint32).view(np.int32)
    rq = RaBitQCodes(
        codes=torch.from_numpy(words).to(dev), norms=f32(norms),
        ip_xo=f32(ip_xo), rotation=f32(rotation), center=f32(center),
        dim=int(dim if dim is not None else graph.dim))
    return EMQGIndex(graph=graph, codes=rq)


def index_to_numpy(index) -> dict:
    """``index``'s fields as numpy arrays, the keyword arguments of
    ``index_from_numpy`` (the code words as their ``uint32`` pattern)."""
    g = index.graph if isinstance(index, EMQGIndex) else index
    out = dict(vectors=g.vectors.cpu().numpy(),
               neighbors=g.neighbors.cpu().numpy(), medoid=g.medoid,
               kind=g.kind, delta=g.delta)
    if isinstance(index, EMQGIndex):
        c = index.codes
        out.update(codes=c.codes.cpu().numpy().view(np.uint32),
                   norms=c.norms.cpu().numpy(), ip_xo=c.ip_xo.cpu().numpy(),
                   rotation=c.rotation.cpu().numpy(),
                   center=c.center.cpu().numpy(), dim=c.dim)
    return out


def sharded_from_numpy(offsets, n_total: int, sizes, vectors, neighbors,
                       medoid, kind: str = "delta_emg", delta: float = 0.0,
                       codes=None, norms=None, ip_xo=None, rotation=None,
                       center=None, dim: Optional[int] = None,
                       device="cuda") -> ShardedIndex:
    """The port's ``ShardedIndex`` from a reference one: every array leaf
    has a leading dim S (``medoid`` is [S]); slot ``s`` is
    ``index_from_numpy`` of the leaves' row ``s``.  ``sizes=None`` keeps
    every row real, as in the reference."""
    rq = codes is not None

    def row(x, s):
        return None if x is None else np.asarray(x)[s]

    slots = tuple(
        index_from_numpy(row(vectors, s), row(neighbors, s), row(medoid, s),
                         kind=kind, delta=delta, codes=row(codes, s),
                         norms=row(norms, s), ip_xo=row(ip_xo, s),
                         rotation=row(rotation, s), center=row(center, s),
                         dim=dim if rq else None, device=device)
        for s in range(len(np.asarray(offsets))))
    return ShardedIndex(
        slots=slots, offsets=tuple(int(o) for o in np.asarray(offsets)),
        n_total=int(n_total),
        sizes=None if sizes is None
        else tuple(int(x) for x in np.asarray(sizes)))


def _tensor(x, dev) -> torch.Tensor:
    """A numpy array (or a bfloat16 one, as ``np.asarray`` gives of a JAX
    bf16 array) as a tensor of the same dtype on ``dev``, bit for bit."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(x)).to(dev)


def lm_params_from_numpy(cfg, tree: dict, device="cuda") -> dict:
    """The port's LM parameters from the reference's tree: ``embed``,
    ``unembed``, ``ln_f``, the unrolled ``head_layers`` (layers ``0 ..
    first_dense − 1``) and ``scan``, a list of ``moe_period`` sub-stacks
    of ``[n_super, ...]`` arrays (one stack for a dense model), whose row
    ``s`` of sub-stack ``j`` is layer ``first_dense + s·period + j``.
    Every array keeps its dtype and orientation (``x @ W``; expert stacks
    ``[E, d, f]``).  A tree whose layers are not the config's (their
    count, the number of sub-stacks, or which of them hold ``moe``) raises
    ``ValueError``."""
    dev = resolve_device(device)
    head, scan = list(tree.get("head_layers") or []), list(tree["scan"])
    n_super = len(np.asarray(scan[0]["wq"])) if scan else 0
    period = cfg.moe_period if cfg.is_moe else 1
    if any(len(np.asarray(sub["wq"])) != n_super for sub in scan) or \
            len(head) + len(scan) * n_super != cfg.n_layers or \
            len(head) != cfg.first_dense or len(scan) != period:
        raise ValueError(
            f"{cfg.name}: the tree holds {len(head)} head layers and "
            f"{len(scan)} scan stacks of {n_super}, not the config's "
            f"{cfg.first_dense} + {cfg.n_scan_layers} layers in "
            f"{period} stacks")
    moe = [i for i, p in enumerate(head + scan * n_super) if "moe" in p]
    if moe != [i for i in range(cfg.n_layers) if _is_moe_layer(cfg, i)]:
        raise ValueError(f"{cfg.name}: the tree's MoE layers {moe} are not "
                         "the config's MoE layers")

    def layer(node, row=None):
        if isinstance(node, dict):
            return {k: layer(v, row) for k, v in node.items()}
        return _tensor(np.asarray(node) if row is None
                       else np.asarray(node)[row], dev)

    layers = [layer(p) for p in head]
    layers += [layer(scan[j], s) for s in range(n_super)
               for j in range(len(scan))]
    return {
        "embed": _tensor(tree["embed"], dev),
        "unembed": _tensor(tree["unembed"], dev),
        "ln_f": _tensor(tree["ln_f"], dev),
        "layers": layers,
    }


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; a bf16 one as the f32 array of the same
    values (numpy has no bfloat16)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def lm_params_to_numpy(cfg, params: dict) -> dict:
    """The reference's layout of a port LM tree (``lm_params_from_numpy``'s
    inverse): ``embed``, ``unembed``, ``ln_f``, the unrolled
    ``head_layers`` and ``scan``, ``moe_period`` sub-stacks whose row ``s``
    of sub-stack ``j`` is layer ``first_dense + s·period + j``, as numpy
    arrays (bf16 as f32 of the same values)."""
    period = cfg.moe_period if cfg.is_moe else 1
    layers = params["layers"]
    if len(layers) != cfg.n_layers or cfg.n_scan_layers % period:
        raise ValueError(f"{cfg.name}: {len(layers)} layers, not the "
                         f"config's {cfg.n_layers} in periods of {period}")

    def tree(node):
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return _to_numpy(node)

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([_to_numpy(n) for n in nodes])

    scan = layers[cfg.first_dense:]
    return {
        "embed": _to_numpy(params["embed"]),
        "unembed": _to_numpy(params["unembed"]),
        "ln_f": _to_numpy(params["ln_f"]),
        "head_layers": [tree(p) for p in layers[:cfg.first_dense]],
        "scan": [stack(scan[j::period]) for j in range(period)],
    }


def train_state_from_numpy(cfg, params: dict, opt_state: dict, step,
                           device="cuda"):
    """A ``train.TrainState`` from a reference ``TrainState``'s fields as
    numpy: its params and the AdamW moments ``m`` and ``v`` (each a tree of
    the params' layout, in their own dtypes) through
    ``lm_params_from_numpy``, the optimizer's and the state's steps as
    int32 scalars."""
    from .train import TrainState

    dev = resolve_device(device)

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)

    return TrainState(
        params=lm_params_from_numpy(cfg, params, device=dev),
        opt_state={"m": lm_params_from_numpy(cfg, opt_state["m"], device=dev),
                   "v": lm_params_from_numpy(cfg, opt_state["v"], device=dev),
                   "step": scalar(opt_state["step"])},
        step=scalar(step))


_INITS = {rs.FMConfig: rs.fm_init, rs.DCNConfig: rs.dcn_init,
          rs.DIENConfig: rs.dien_init, rs.MINDConfig: rs.mind_init,
          gnn.GATConfig: gnn.init}


def _params_from_numpy(cfg, tree: dict, device) -> dict:
    """The port's parameters of the recsys or GAT config ``cfg`` from the
    reference's tree (nested dicts of numpy arrays), each leaf in its own
    dtype.  A tree whose keys or shapes are not those of the port's init
    for ``cfg`` (run on the meta device: nothing allocated) raises
    ``ValueError`` before any tensor is made."""
    dev = resolve_device(device)
    want = tree_map(lambda t: tuple(t.shape),
                    _INITS[type(cfg)](cfg, device="meta"))

    def same(w, node, path):
        if isinstance(w, dict):
            if not isinstance(node, dict) or set(node) != set(w):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{cfg.name}: {path or 'the tree'} holds "
                                 f"{got}, not the config's {sorted(w)}")
            for k in w:
                same(w[k], node[k], f"{path}/{k}")
        elif tuple(np.shape(node)) != w:
            raise ValueError(f"{cfg.name}: {path} has shape "
                             f"{tuple(np.shape(node))}, not the config's {w}")

    same(want, tree, "")
    return tree_map(lambda x: _tensor(x, dev), tree)


def recsys_params_from_numpy(cfg, tree: dict, device="cuda") -> dict:
    """The port's parameters of the recsys config ``cfg`` from the
    reference's tree (see ``_params_from_numpy``)."""
    return _params_from_numpy(cfg, tree, device)


def recsys_params_to_numpy(params: dict) -> dict:
    """A port recsys tree (parameters, gradients, moments) as the
    reference's nested dicts of numpy arrays."""
    return tree_map(_to_numpy, params)


def gnn_params_from_numpy(cfg, tree: dict, device="cuda") -> dict:
    """The port's GAT parameters of ``cfg`` from the reference's tree
    (``layer{i}`` dicts of numpy arrays), checked against the port's init
    for ``cfg`` (see ``_params_from_numpy``)."""
    return _params_from_numpy(cfg, tree, device)


def gnn_params_to_numpy(params: dict) -> dict:
    """A port GAT tree (parameters, gradients, moments) as the reference's
    nested dicts of numpy arrays."""
    return tree_map(_to_numpy, params)
