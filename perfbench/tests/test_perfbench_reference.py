"""The plain reference against brute force and against the port, at tiny
sizes on the CPU; whole runs of both cells on the CPU come out correct."""

import numpy as np
import pytest
import torch

from pbench import annref
from pbench.cell import Cell, run_cell


def test_exact_topk_is_brute_force():
    g = torch.Generator().manual_seed(3)
    base = torch.randn((700, 24), generator=g)
    q = torch.randn((37, 24), generator=g)
    annref.BLOCK_ELEMS, old = 5000, annref.BLOCK_ELEMS    # several blocks
    try:
        ids, d = annref.exact_topk(base, q, 10, "l2")
        ipi, ip = annref.exact_topk(base, q, 10, "ip")
    finally:
        annref.BLOCK_ELEMS = old
    b, qq = base.double().numpy(), q.double().numpy()
    full = np.sqrt(((qq[:, None] - b[None]) ** 2).sum(-1))
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(full, want, 1),
                               rtol=1e-12)
    dots = qq @ b.T
    want = np.argsort(-dots, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ipi.numpy(), want)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.0, -1.0 - 2 ** -11])
    r = annref.tf32_round(x)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0, 3.0, -1.0 - 2 ** -10]


def test_code_bits_and_graph_checks():
    from repro_torch.core import rabitq
    g = torch.Generator().manual_seed(5)
    x = torch.randn((300, 40), generator=g)
    rot = rabitq.random_rotation(40, torch.Generator().manual_seed(2))
    codes = rabitq.fit(x, rot).codes
    assert annref.code_bits_off(x, codes, rot) == 0
    flipped = codes.clone()
    flipped[7, 0] ^= 1 << 3
    assert annref.code_bits_off(x, flipped, rot) == 1
    assert annref.code_bits_off(x, codes, rot * 1.01) == 300 * 40
    nb = torch.tensor([[1, 2, -1], [0, -1, -1], [0, 1, -1]])
    assert annref.graph_bad(nb, 3, 3) == 0
    for row in ([0, 2, -1], [1, 1, -1], [-1, -1, -1], [1, 3, -1]):
        bad = nb.clone()
        bad[0] = torch.tensor(row)
        assert annref.graph_bad(bad, 3, 3) == 1, row


def test_a_whole_run_on_the_cpu_is_correct(tiny_bench):
    cell = Cell("synth-d128.batch", bench_dir=tiny_bench)
    line = run_cell(cell, 2 ** 33 + 1, 0.0, False, "cpu", 0.0,
                    log=lambda m: None)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert 0 < line["metrics"]["recall"]["value"] <= 1
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.config["limits"])
