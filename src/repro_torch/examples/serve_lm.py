"""Serving example: batched greedy decoding through the static-capacity
cache, with the decode stream's telemetry served through the streaming
ingress path.  The generated tokens form a hypersparse network (their
``(prev, next)`` bigram graph); it goes over a loopback TCP socket into
``D4MStream.serve()`` (sources -> router -> engine, the loop a deployment
runs), and drain, checkpoint and a bit-identical restore are checked at the
end.  On the card the K=4 session runs the ``cuda`` engine: ``sort_dedup``
canonicalises each microbatch, ``hier_cascade`` steps the instances and
``merge_add`` builds the snapshots.

Run::

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2_1_3b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

Prints ``SERVE_OK`` when every check holds.
"""
from __future__ import annotations

import argparse
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import d4m, serve
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import serving as SV
from repro_torch.models import transformer as TF


def _require(ok, what) -> None:
    if not ok:
        raise AssertionError(what)


def make_model(cfg, batch: int, prompt_len: int, device, seed: int = 0):
    """Random weights, prompts and (whisper) stub encoder frames from
    ``seed``, drawn on ``device``: ``(params, prompts, frontend_embeds)``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = TF.init_params(gen, cfg, dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=dev, dtype=torch.int32)
    fe = None
    if cfg.encoder_layers:
        fe = torch.randn((batch, cfg.encoder_tokens, cfg.d_model), generator=gen, device=dev) * 0.02
    return params, prompts, fe


def bigrams_of(tokens: np.ndarray):
    """The ``(prev, next)`` pairs of each generated sequence, int32."""
    return (tokens[:, :-1].reshape(-1).astype(np.int32), tokens[:, 1:].reshape(-1).astype(np.int32))


def serve_bigrams(tokens: np.ndarray, device, checkpoint_dir: str) -> dict:
    """Serve ``tokens``' bigram graph over a loopback socket into a K=4
    session, check the drain, the checkpoint cursor and a bit-identical
    restore, and return the report and the snapshot's live triples."""
    prev, nxt = bigrams_of(tokens)
    n_pairs = prev.shape[0]
    batch = max(16, n_pairs // 8)
    scfg = d4m.StreamConfig(
        cuts=(max(64, n_pairs // 2),),
        top_capacity=4 * n_pairs,
        batch_size=batch,
        instances_per_device=4,
        serve=d4m.ServeConfig(max_latency_ms=20.0, checkpoint_every=4),
    )
    sess = d4m.D4MStream(scfg, device=device, checkpoint_dir=checkpoint_dir)

    src = serve.TCPSource(port=0).start()
    print(f"serving decode telemetry on 127.0.0.1:{src.port} (engine={sess.kind}, K={sess.n_instances})")
    errors = []

    def send():
        try:
            serve.send_triples("127.0.0.1", src.port, prev, nxt, np.ones(n_pairs, np.float32),
                               chunk_records=batch)
        except Exception as e:  # surfaced after the join
            errors.append(e)

    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    report = sess.serve(src)
    sender.join(timeout=30)
    _require(not sender.is_alive() and not errors, ("sender", errors))

    tel = report.telemetry
    print(f"served {report.records_fed}/{report.records_in} records in {report.batches_fed} microbatches "
          f"at {report.ingest_rate:,.0f}/s (dropped={report.records_dropped}, "
          f"blocked={report.blocked_events}, checkpoints={[c['step'] for c in report.checkpoints]})")

    # drain + checkpoint checks
    _require(report.drained, "serve did not drain")
    _require(report.records_fed == n_pairs, (report.records_fed, n_pairs))
    _require(report.records_dropped == 0 and report.malformed == 0, "dropped or malformed records")
    _require(report.checkpoints and report.checkpoints[-1]["cursor"] == n_pairs, report.checkpoints)
    _require(tel["session"]["nnz_total"] == sess.nnz(), "telemetry nnz")
    sess.wait_checkpoint()

    # a restarted session restores the drain checkpoint bit-identically
    restored = d4m.D4MStream(scfg, device=device, checkpoint_dir=checkpoint_dir)
    extra = restored.restore()
    _require(extra["cursor"] == n_pairs and extra["final"], extra)
    a, b = restored.snapshot(), sess.snapshot()
    for name in ("rows", "cols", "vals"):
        _require(torch.equal(getattr(a, name), getattr(b, name)), f"restored snapshot {name}")

    nnz = sess.nnz()
    k = min(3, nnz)
    ids, counts = b.topk(k)
    print(f"decode telemetry: {nnz} distinct bigrams; top sources {ids.tolist()} "
          f"x{[int(c) for c in counts.tolist()]}")
    return {
        "report": report,
        "kind": sess.kind,
        "n_pairs": n_pairs,
        "snapshot": tuple(getattr(b, n)[:nnz].cpu().numpy() for n in ("rows", "cols", "vals")),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o_danube3_4b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    params, prompts, fe = make_model(cfg, args.batch, args.prompt_len, args.device)
    t0 = time.perf_counter()
    out = SV.greedy_generate(params, cfg, prompts, steps=args.gen, s_cap=args.prompt_len + args.gen,
                             frontend_embeds=fe)
    tokens = out.cpu().numpy()
    dt = time.perf_counter() - t0
    toks = args.batch * (args.prompt_len + args.gen)
    print(f"arch={cfg.name} generated {tuple(out.shape)} on {args.device} in {dt:.2f}s "
          f"({toks / dt:.0f} tok/s incl. first-call set-up)")
    print("sample:", tokens[0][:12].tolist())

    with tempfile.TemporaryDirectory(prefix="serve_lm_ckpt_") as ckpt_dir:
        served = serve_bigrams(tokens, args.device, ckpt_dir)
    print("SERVE_OK")
    return {"tokens": tokens, **served}


if __name__ == "__main__":
    main()
