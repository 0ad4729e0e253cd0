"""An ANN configuration served through the port's ``launch.steps.
ann_serve``: the quantized probing search of every shard and the
all-gather top-k merge over a ``ShardedIndex`` built by
``core.distributed.build_sharded``.

Its configuration file gives the corpus (``n``, ``dim`` and the law in
``corpus``), ``shards``, the ``build`` and ``search`` parameters,
``graph_check`` and ``warmup_queries``; its traffic gives
``queries_per_call``.  The corpus and the queries are one fixed data set,
drawn on the device from the configuration's ``data_seed``, as SIFT1M's
base and test sets are; the run's seed orders the queries: call ``i``
sends the whole query set permuted by ``(seed, 1, i)``.  Every seed so
does the same work (a lock-step call lasts as long as its slowest query,
so queries drawn per seed changed a call's length by up to 8%).
"""

from __future__ import annotations

import time
import types

import torch

from pbench import annref, data
from pbench.launches import fused_estimate_launches, sync
from pbench.peaks import ann_serve_flops

# what the program built and holds: freed before the reference runs
PROGRAM_STATE = ("sidx", "run")


def _law(cfg: dict, device) -> dict:
    c = cfg["corpus"]
    return data.subspace_law(cfg["dim"], c["n_clusters"], c["rank"],
                             c["center_std"],
                             data.generator(device, cfg["data_seed"], 0))


def _points(state: dict, n: int, *key: int) -> torch.Tensor:
    c = state["cfg"]["corpus"]
    return data.subspace_points(
        state["law"], n, c["spread"], c["noise"],
        data.generator(state["device"], state["cfg"]["data_seed"], *key))


def setup(cfg: dict, seed: int, device, build: bool = True) -> dict:
    state = {"cfg": cfg, "seed": seed, "device": torch.device(device),
             "law": _law(cfg, device)}
    state["base_dev"] = _points(state, cfg["n"], 1)
    if not build:
        return state
    from repro_torch.core import BuildParams, SearchParams
    from repro_torch.core.distributed import build_sharded
    from repro_torch.launch.steps import ann_serve

    bp = BuildParams(**cfg["build"])
    state["sidx"] = build_sharded(state["base_dev"].cpu().numpy(),
                                  cfg["shards"], bp, quantized=True,
                                  seed=bp.seed, device=device)
    arch = types.SimpleNamespace(
        id=cfg["name"], family="ann",
        model_cfg={"dim": cfg["dim"], "search": SearchParams(**cfg["search"])})
    shape = types.SimpleNamespace(kind="ann_serve", name="serve", dims={})
    state["run"] = ann_serve(arch, shape, state["sidx"])
    sync(device)
    return state


def query_set(state: dict, size: int) -> torch.Tensor:
    """The fixed set of ``size`` queries, on the device (made once)."""
    sets = state.setdefault("query_sets", {})
    if size not in sets:
        sets[size] = _points(state, size, 2, size)
    return sets[size]


def make_inputs(state: dict, traffic: dict, seed: int, index: int,
                size=None) -> dict:
    B = size or traffic["queries_per_call"]
    order = torch.from_numpy(data.rng_for(seed, 1, index).permutation(B))
    return {"queries": query_set(state, B)[order.to(state["device"])],
            "n_queries": B}


def warmup(state: dict, traffic: dict, seed: int) -> None:
    query_set(state, traffic["queries_per_call"])
    call(state, make_inputs(state, traffic, seed, 0,
                            size=state["cfg"]["warmup_queries"]))


def call(state: dict, inp: dict):
    """One served batch, synchronised: (outputs, record)."""
    cfg, B = state["cfg"], inp["n_queries"]
    stats = {}
    launches = fused_estimate_launches()
    t0 = time.perf_counter()
    ids, dists = state["run"](inp["queries"], stats)
    sync(state["device"])
    secs = time.perf_counter() - t0
    hops = torch.stack([stats["n_hops"][s] for s in sorted(stats["n_hops"])])
    return ({"ids": ids, "dists": dists, "hops": hops},
            {"seconds": secs, "search_seconds": secs,
             "iterations": fused_estimate_launches() - launches, "queries": B,
             "flops": ann_serve_flops(B, cfg["shards"],
                                      cfg["search"]["l_max"], cfg["dim"])})


def control_call(state: dict, inp: dict, ref):
    """The reference in the program's place, in the precision below the
    configuration's: exact k-NN in float32 with TF32 products."""
    k = state["cfg"]["search"]["k"]
    ids, dists = ref.exact_knn(state["base_dev"], inp["queries"], k,
                               control=True)
    return {"ids": ids.to(torch.int32), "dists": dists.float()}, {}


def snapshot(state: dict) -> dict:
    """What the check reads of the built index, on the host."""
    slot = state["sidx"].slots[0]
    return {"neighbors": slot.graph.neighbors.cpu(),
            "medoid": int(slot.graph.medoid),
            "codes": slot.codes.codes.cpu(),
            "rotation": slot.codes.rotation.cpu()}


def check(state: dict, snap, calls: list, ref, device) -> dict:
    """The numbers compared, with the recall, over every call's answers:
    ``bad_rows`` (served rows that are no valid answer), ``dist_err``
    (largest gap between a served distance and the float64 distance of
    the served id, over the query's exact k-th distance), ``recall_miss``
    (the share of the exact top-k that the served rows miss), and of the
    built index (``snap``; None for the control) ``graph_miss`` (the same
    share for the reference's own beam search over the port's graph, on a
    sample of call 0's queries), ``degree_short``, ``graph_bad`` and
    ``code_bits_off``."""
    cfg = state["cfg"]
    n, k, s = cfg["n"], cfg["search"]["k"], cfg["search"]
    base = state["base_dev"].to(device)
    bad, err, hits, total = 0, 0.0, 0, 0
    for inp, out in calls:
        q = inp["queries"].to(device)
        ids, dists = out["ids"].to(device), out["dists"].to(device)
        ex_ids, ex_d = ref.exact_knn(base, q, k)
        bad += annref.bad_rows(ids, dists, n)
        gap = (dists.double() - annref.l2_of(base, q, ids)).abs() \
            / ex_d[:, -1:].clamp_min(1e-30)
        gap = gap[torch.isfinite(gap)]
        if gap.numel():
            err = max(err, float(gap.max()))
        hits += annref.recall_hits(ids, ex_ids)
        total += q.shape[0] * k
    recall = hits / max(total, 1)
    numbers = {"bad_rows": bad, "dist_err": err, "recall_miss": 1.0 - recall}
    if snap is not None:
        nb = snap["neighbors"].to(device)
        q0 = calls[0][0]["queries"].to(device)
        rows = annref.sample_rows(q0.shape[0], cfg["graph_check"]["queries"],
                                  state["seed"], device)
        want, _ = ref.exact_knn(base, q0[rows], k)
        got = annref.graph_search(base, nb, snap["medoid"], q0[rows],
                                  s["l_max"], 4 * s["l_max"])
        numbers["graph_miss"] = 1.0 - annref.recall_hits(got[:, :k], want) \
            / (rows.numel() * k)
        numbers["degree_short"] = annref.degree_short(
            nb, cfg["build"]["max_degree"])
        numbers["graph_bad"] = annref.graph_bad(
            nb, cfg["build"]["max_degree"], n)
        numbers["code_bits_off"] = annref.code_bits_off(
            base, snap["codes"].to(device), snap["rotation"].to(device))
    return {"numbers": numbers, "recall": recall,
            "attempted": sum(q["n_queries"] for q, _ in calls),
            "failed": bad}
