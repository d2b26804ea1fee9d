"""The port's D4M examples end to end on the CPU at a small group:
``quickstart`` (Fig. 1's algebra, the single cascade, the query namespace)
and ``streaming_analytics`` (the mesh engine at D>1, two checkpoints and
the restore drill, which the example checks itself).  Each snapshot is
held to numpy's counts of the example's own stream, and the top-k to
numpy's out-degrees."""
import numpy as np
import pytest
import torch

from repro_torch.data import dictionary, rmat
from repro_torch.examples import quickstart, streaming_analytics


def _counts(src, dst):
    keys, counts = np.unique(src.astype(np.int64) * 2**32 + dst.astype(np.int64), return_counts=True)
    return (keys >> 32).astype(np.int32), (keys & 0xFFFFFFFF).astype(np.int32), counts.astype(np.float32)


def _check_stream(out, src, dst, k=5):
    rows, cols, vals = _counts(src, dst)
    np.testing.assert_array_equal(out["snapshot"][0], rows)
    np.testing.assert_array_equal(out["snapshot"][1], cols)
    np.testing.assert_array_equal(out["snapshot"][2], vals)
    ids, counts = out["top_k"]
    deg = np.bincount(src.astype(np.int64))
    order = np.lexsort((np.arange(deg.size), -deg))[:k]
    np.testing.assert_array_equal(counts, deg[order].astype(counts.dtype))
    assert (deg[ids.astype(np.int64)] == counts).all()


def test_quickstart_example(capsys):
    out = quickstart.main(["--device", "cpu", "--group", "128", "--total-edges", "2048", "--scale", "10"])
    text = capsys.readouterr().out
    assert "two-hop pairs: 4" in text and "max.plus union nnz: 8" in text
    assert out["kind"] == "single"
    a = out["algebra"]
    one = int(dictionary.encode_ipv4(["1.1.1.1"])[0])
    assert a["A"][0].size == 4 and a["sym"][0].size == 8 and a["hot"][0].size == 4
    np.testing.assert_array_equal(a["row"][0], [one, one])
    gen = torch.Generator().manual_seed(0)
    s, d, _ = rmat.stream_tensor(gen, 16, 128, 10)
    _check_stream(out, s.numpy().ravel(), d.numpy().ravel())
    assert sum(out["nnz_per_layer"]) >= out["snapshot"][0].size


@pytest.mark.parametrize("devices", [1, 2])
def test_streaming_analytics_example(devices, capsys):
    out = streaming_analytics.main(["--device", "cpu", "--devices", str(devices), "--group", "64",
                                    "--groups", "6", "--every", "3", "--scale", "10"])
    assert "restart drill ok" in capsys.readouterr().out
    assert out["kind"] == ("mesh" if devices > 1 else "single") and out["n_instances"] == devices
    assert out["drill"] == {"replayed_from": 3, "restored": 6}
    gen = torch.Generator().manual_seed(0)
    draws = [rmat.rmat_edges_torch(gen, (devices, 64), 10) for _ in range(6)]
    src = np.concatenate([s.numpy().ravel() for s, _ in draws])
    dst = np.concatenate([d.numpy().ravel() for _, d in draws])
    _check_stream(out, src, dst)
