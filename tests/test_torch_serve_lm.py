"""The port's serving example end to end on the CPU: greedy decode at the
reference example's sizes, the bigram telemetry over a loopback socket
into a K=4 ``D4MStream.serve()``, drain, checkpoint and a bit-identical
restore; ``SERVE_OK`` printed, and the served snapshot equal to numpy's
counts of the example's own bigrams."""
import numpy as np
import pytest

from repro_torch.examples import serve_lm


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "mamba2_1_3b"])
def test_serve_lm_example(arch, capsys):
    out = serve_lm.main(["--device", "cpu", "--arch", arch])
    assert capsys.readouterr().out.rstrip().endswith("SERVE_OK")
    tokens = out["tokens"]
    assert tokens.shape == (4, 24) and tokens.dtype == np.int32
    prev, nxt = serve_lm.bigrams_of(tokens)
    keys, counts = np.unique(prev.astype(np.int64) * 2**32 + nxt, return_counts=True)
    rows, cols, vals = out["snapshot"]
    np.testing.assert_array_equal(rows, (keys >> 32).astype(np.int32))
    np.testing.assert_array_equal(cols, (keys & 0xFFFFFFFF).astype(np.int32))
    np.testing.assert_array_equal(vals, counts.astype(np.float32))
    assert out["kind"] == "packed" and out["n_pairs"] == 4 * 23
