#!/usr/bin/env python
"""Serving CLI — run a trained checkpoint as an HTTP synthesis service.

No reference counterpart (the reference synthesizes by running its generate
script per utterance); this is the deployment surface the framework adds:
one hot compiled decoder, concurrent requests microbatched into it
(wavenet_tpu/serving).

Examples:
  python serve.py --ckpt runs/lj --port 8000
  curl -X POST localhost:8000/synthesize \
       -d '{"seconds": 2.0, "seed": 7}' -o out.wav
  curl -X POST localhost:8000/synthesize \
       -d '{"seconds": 10.0, "stream": true}' --output raw.pcm   # int16 PCM
  curl localhost:8000/info
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="checkpoint directory")
    src.add_argument("--npz", help="export_npz single-file weights")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--no-ema", action="store_true",
                   help="serve raw training weights instead of the EMA")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="microbatch row cap (requests group up to this)")
    p.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="batching window: how long a request waits for "
                        "company before the batch launches")
    p.add_argument("--chunk-seconds", type=float, default=0.5,
                   help="decode chunk size (streaming time-to-first-byte)")
    p.add_argument("--length-quantum-seconds", type=float, default=0.5,
                   help="requested lengths round up to this quantum "
                        "(bounds the compile cache)")
    p.add_argument("--data-parallel", type=int, default=1, metavar="N",
                   help="decode each microbatch across N devices on the "
                        "data (batch) mesh axis (distributed AR serving; "
                        "responses arrive one-shot, not chunked)")
    p.add_argument("--model-parallel", type=int, default=1, metavar="N",
                   help="shard the conv stack's channels across N devices "
                        "with per-layer collective state exchange")
    p.add_argument("--warmup-seconds", type=float, default=0.0,
                   help="synthesize this much audio through EVERY batch "
                        "bucket (1, 2, 4, ... max-batch) at boot so the "
                        "first real requests hit warm jits regardless of "
                        "how they group")
    p.add_argument("--scan-unroll", type=int, default=None, metavar="K",
                   help="unroll the XLA scan decoder's layer scan K-way "
                        "(cfg.decode_unroll override; the persistent "
                        "compilation cache amortizes the longer compile). "
                        "Ignored on kernel-served configs")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from wavenet_tpu.models.api import WaveNet
    from wavenet_tpu.serving import WaveNetServer
    from wavenet_tpu.serving.http import make_server
    from wavenet_tpu.utils import compcache

    print(f"compilation cache: {compcache.enable()}", file=sys.stderr)

    if args.npz:
        model = WaveNet.from_npz(args.npz)
    else:
        model = WaveNet.from_checkpoint(args.ckpt, step=args.step,
                                        use_ema=not args.no_ema)
    if args.scan_unroll:
        model = model.replace_config(decode_unroll=args.scan_unroll)
    mesh = None
    if args.data_parallel * args.model_parallel > 1:
        import dataclasses
        from wavenet_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(dataclasses.replace(
            model.cfg, data_parallel=args.data_parallel,
            model_parallel=args.model_parallel, seq_parallel=1))
        print(f"distributed serving over mesh "
              f"data={args.data_parallel} model={args.model_parallel}")
    engine = WaveNetServer(model, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms,
                           chunk_seconds=args.chunk_seconds,
                           length_quantum_seconds=args.length_quantum_seconds,
                           mesh=mesh)
    if args.warmup_seconds > 0:
        engine.warmup(seconds=args.warmup_seconds, verbose=True)

    server = make_server(engine, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"serving {args.ckpt or args.npz} on http://{host}:{port} "
          f"(max_batch={args.max_batch}, chunk={args.chunk_seconds}s)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        engine.close(wait=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
