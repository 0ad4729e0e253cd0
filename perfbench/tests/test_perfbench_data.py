"""The benchmark's generator, and the configuration files
against the port's registry."""

import json
from pathlib import Path

import torch

from pbench import data

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 40 + 7


def _lid(x, q, k=20):
    """Mean MLE local intrinsic dimension of ``q`` over ``x``'s ``k``
    nearest neighbours (none of them ``q`` itself)."""
    d = torch.cdist(q.double(), x.double())
    v = torch.topk(d, k, largest=False).values
    return float((-1.0 / torch.log(v[:, :-1] / v[:, -1:]).mean(1)).mean())


def test_subspace_points_are_keyed_and_of_low_intrinsic_dimension():
    law = data.subspace_law(128, 8, 10, 0.3, data.generator("cpu", SEED, 0))
    x = data.subspace_points(law, 6000, 1.0, 0.05,
                             data.generator("cpu", SEED, 1))
    again = data.subspace_points(
        data.subspace_law(128, 8, 10, 0.3, data.generator("cpu", SEED, 0)),
        6000, 1.0, 0.05, data.generator("cpu", SEED, 1))
    assert x.dtype == torch.float32 and x.shape == (6000, 128)
    assert torch.equal(x, again)
    q = data.subspace_points(law, 300, 1.0, 0.05,
                             data.generator("cpu", SEED, 2))
    assert torch.cdist(q, x).min() > 0          # no query is a corpus point
    lid = _lid(x, q)
    iso = _lid(torch.randn((6000, 128), generator=torch.Generator()
                           .manual_seed(1)), q * 0 + torch.randn(
                               (300, 128), generator=torch.Generator()
                               .manual_seed(2)))
    assert 7 < lid < 14 and iso > 3 * lid, (lid, iso)


def test_assigned_points_keep_to_their_clusters():
    law = data.subspace_law(16, 3, 2, 10.0, data.generator("cpu", 5, 0))
    assign = torch.tensor([0, 0, 1, 2, 2, 2])
    x = data.subspace_points(law, 6, 0.1, 0.0, data.generator("cpu", 5, 1),
                             assign=assign)
    nearest = torch.cdist(x, law["centres"]).argmin(1)
    assert torch.equal(nearest, assign)


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_synth_d128_is_the_registrys_sift1m_but_for_what_it_reduces():
    from repro_torch.configs import get_arch
    arch, cfg = get_arch("sift1m"), _cfg("synth-d128")
    assert cfg["dim"] == arch.model_cfg["dim"]
    assert sorted(cfg["reduced"]) == ["build", "n"]
    b = arch.model_cfg["build"]
    for key, value in cfg["build"].items():
        if key != "block":
            assert getattr(b, key) == value, key
    s = arch.model_cfg["search"]
    for key, value in cfg["search"].items():
        assert getattr(s, key) == value, key
    assert cfg["n"] < arch.model_cfg["n"]

