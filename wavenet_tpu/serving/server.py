"""In-process synthesis server: request microbatching over streaming decode.

The reference "serves" by running generate.py per utterance — one process,
one request, O(RF) python per sample (SURVEY.md §3.2).  The equivalent
here is an engine that keeps ONE compiled decoder hot and feeds it
batches: concurrent requests are grouped into fixed-shape microbatches
(length/temperature buckets, rows padded to a bucketed batch size so the
jit cache stays bounded), the whole batch decodes in one streaming scan,
and each request receives its own waveform chunks as they are produced.

Design points:
  * Each request's audio depends ONLY on its own seed: rows sample from the
    counter RNG (ops/rng.py) keyed by the request seed, so re-submitting a
    request reproduces its audio bit-exactly REGARDLESS of what other
    traffic happens to be co-batched with it, and a client can replay any
    single response with WaveNet.stream(batch=1, seeds=[seed]).
  * Shapes are static per (length-bucket, batch-bucket, temperature)
    group — each group compiles once, then every future batch with that
    signature reuses the executable.  Padding rows are dummy speaker-0
    requests whose outputs are dropped; per-request lengths are trimmed
    from the bucketed scan length on the way out.
  * Conditioned (mel / primed) requests run on their OWN decode lane (a
    second worker thread), so a long vocoder request never head-of-line-
    blocks the batchable lane: both lanes stream in chunks and interleave
    at chunk granularity on the device queue.  Within the
    conditioned lane, MEL requests with matching (length-bucket,
    temperature) signatures BATCH (round 5 — the flagship-vocoder product
    path): each row upsamples its own mel at its own length (bit-identical
    to its singleton replay) and the feature timelines zero-pad to the
    group scan length, which AR causality keeps invisible in every row's
    emitted prefix.  Primed requests stay singletons (request-specific prime
    length).
  * Chunks flow through per-request queues (unbounded: one second of
    16 kHz float32 audio is 64 KB, so a lagging consumer costs memory
    proportional to its own utterance, never stalls the decode loop).
"""

from __future__ import annotations

import itertools
import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np


def _bucket(n: int, quantum: int) -> int:
    """Round n up to a multiple of quantum (compile-cache bounding)."""
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def _batch_bucket(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


@dataclass
class _Request:
    num_samples: int
    seed: int
    temperature: float
    speaker: Optional[int]
    mel: Optional[np.ndarray]
    prime: Optional[np.ndarray] = None
    chunks: "queue.Queue" = field(default_factory=queue.Queue)
    error: Optional[BaseException] = None


_DONE = object()


class ResponseStream:
    """Handle returned by submit(): iterate waveform chunks, or collect all.

    Iterating yields float32 [n] arrays in [-1, 1]; waveform() concatenates
    whatever has not been consumed yet (so `first = next(iter(h))` then
    `rest = h.waveform()` composes).  The stream is one-shot: once
    exhausted, further iteration yields nothing and waveform() returns an
    empty array.  Raises the server-side exception (if any) at the point of
    consumption.
    """

    def __init__(self, req: _Request, rate: int):
        self._req = req
        self._exhausted = False
        self.sample_rate = rate
        self.num_samples = req.num_samples

    def __iter__(self) -> Iterator[np.ndarray]:
        while not self._exhausted:
            item = self._req.chunks.get()
            if item is _DONE:
                self._exhausted = True
                if self._req.error is not None:
                    raise self._req.error
                return
            yield item

    def waveform(self) -> np.ndarray:
        parts = list(self)
        return (np.concatenate(parts) if parts
                else np.zeros((0,), np.float32))


class WaveNetServer:
    """Microbatching synthesis engine around a WaveNet facade.

    server = WaveNetServer(model, max_batch=8)
    h = server.submit(seconds=1.0, speaker=3, seed=17)
    audio = h.waveform()          # or: for chunk in h: play(chunk)
    server.close()

    max_wait_ms bounds the batching latency: the worker collects requests
    for up to that long (or until max_batch are waiting), then launches.

    mesh: optional jax.sharding.Mesh with (data, model) axes — each
    microbatch then decodes through the DISTRIBUTED AR generator
    (multi-device cached-state + token exchange via collectives, SURVEY.md
    P3) instead of the single-device streamer — STREAMING chunk-for-chunk
    like the single-device path (stream_distributed), with the decode
    kernel fanned over the data axis where the router picks it
    (wavenet_tpu.route.dp_decode).  Batch buckets round up to
    a multiple of the mesh's data-axis size so rows shard evenly.  Rows
    keep their own request seeds (the distributed decoder's counter RNG is
    per-row and layout-independent), so responses replay bit-exactly
    across mesh shapes AND batch compositions.
    """

    def __init__(self, model, max_batch: int = 8, max_wait_ms: float = 10.0,
                 chunk_seconds: float = 0.5,
                 length_quantum_seconds: float = 0.5, mesh=None):
        self.model = model
        self.mesh = mesh
        self.cfg = model.cfg
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.chunk_samples = max(1, int(chunk_seconds * self.cfg.sample_rate))
        self.length_quantum = max(
            1, int(length_quantum_seconds * self.cfg.sample_rate))
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0,
                      "samples_out": 0, "decode_seconds": 0.0}
        self._stats_lock = threading.Lock()
        if self.cfg.mel is not None:
            # per-row mel upsampling as ONE compiled call per (frames,
            # length) shape instead of op-by-op dispatch (jax.jit caches
            # by input shape; `length` is static)
            import jax
            from wavenet_tpu.models.conditioning import upsample_mel
            self._upsample_jit = jax.jit(
                lambda m, n: upsample_mel(self.model.params["upsampler"],
                                          self.cfg.mel, m, n),
                static_argnums=1)
        # two decode lanes: fixed-shape batchable traffic, and dynamic-shape
        # (mel/primed) singletons — so neither head-of-line-blocks the other
        self._inbox: "queue.Queue" = queue.Queue()
        self._inbox_single: "queue.Queue" = queue.Queue()
        # guards the closed-check + enqueue pair in submit() against a
        # concurrent close(): nothing may enter the inboxes after _DONE
        self._submit_lock = threading.Lock()
        self._closed = False
        self._workers = [
            threading.Thread(target=self._run, args=(self._inbox,),
                             daemon=True),
            threading.Thread(target=self._run,
                             args=(self._inbox_single,), daemon=True),
        ]
        for w in self._workers:
            w.start()

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    # ---- client surface ----

    def submit(self, seconds: Optional[float] = None,
               num_samples: Optional[int] = None, seed: int = 0,
               temperature: float = 1.0, speaker: Optional[int] = None,
               mel: Optional[np.ndarray] = None,
               prime: Optional[np.ndarray] = None) -> ResponseStream:
        """Enqueue one utterance; returns immediately with a ResponseStream.

        prime: optional [P] float waveform in [-1, 1] to continue from
        (mu-law encoded here; the emitted audio excludes the prime).  Like
        mel, priming carries request-specific shapes, so primed requests
        decode as singleton batches.
        """
        if num_samples is None:
            if seconds is None:
                raise ValueError("pass seconds= or num_samples=")
            num_samples = int(seconds * self.cfg.sample_rate)
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        if speaker is not None:
            if self.cfg.global_classes is None:
                raise ValueError("model has no global conditioning; "
                                 "speaker= is not an input")
            if not 0 <= int(speaker) < self.cfg.global_classes:
                # XLA's gather clamps out-of-range ids silently — reject
                # here instead of synthesizing the wrong speaker
                raise ValueError(
                    f"speaker={speaker} out of range "
                    f"[0, {self.cfg.global_classes})")
        if prime is not None:
            prime = np.asarray(prime, np.float32).reshape(-1)
            if prime.size == 0:
                prime = None
        if mel is not None:
            if self.cfg.mel is None:
                raise ValueError("model is unconditional; mel= is not an "
                                 "input")
            # full shape validation HERE so a bad request cannot poison the
            # co-batched rows of its decode group (round 5: mel requests
            # batch); normalize to [frames, M]
            m = np.asarray(mel, np.float32)
            if m.ndim == 3 and m.shape[0] == 1:
                m = m[0]
            M = self.cfg.mel.num_mels
            if m.ndim != 2 or m.shape[1] != M:
                raise ValueError(
                    f"mel must be [frames, {M}] (or [1, frames, {M}]); "
                    f"got shape {np.asarray(mel).shape}")
            cap = m.shape[0] * self.cfg.mel.hop_length
            # a primed request's conditioning timeline spans the priming
            # steps too: max(P-1, 0) + num_samples total (the facade's
            # _upsampled_cond rule)
            span = max(prime.size - 1, 0) if prime is not None else 0
            if span + num_samples > cap:
                raise ValueError(
                    f"num_samples={num_samples}"
                    + (f" (+{span} priming steps)" if span else "")
                    + f" exceeds the {cap} samples covered by "
                    f"{m.shape[0]} mel frames")
            mel = m
        req = _Request(int(num_samples), int(seed), float(temperature),
                       None if speaker is None else int(speaker),
                       mel, prime)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._bump("requests")
            if req.mel is not None or req.prime is not None:
                self._inbox_single.put(req)      # dynamic-shape lane
            else:
                self._inbox.put(req)
        return ResponseStream(req, self.cfg.sample_rate)

    def synthesize(self, **kw) -> np.ndarray:
        """Blocking convenience: submit() + waveform()."""
        return self.submit(**kw).waveform()

    def warmup(self, seconds: float = 1.0, verbose: bool = False) -> None:
        """Compile every batch bucket (1, 2, 4, ..., max_batch) by pushing
        `seconds` of synthesis through each, so the first real requests
        hit warm executables regardless of how they group.  On a
        mel-conditional model the warmup rows CARRY MEL (zeros at the
        bucket-aligned frame count): vocoder traffic is the product load
        there, and the mel path owns extra executables (the per-row
        upsampler + the conditioned decode) that cost minutes of remote
        compile on first touch.  Runs the decode groups directly on the
        calling thread (deterministic bucket coverage, independent of
        batching-window timing)."""
        import time
        n = max(1, int(seconds * self.cfg.sample_rate))
        mel_w = None
        if self.cfg.mel is not None:
            frames = -(-_bucket(n, self.length_quantum)
                       // self.cfg.mel.hop_length) + 1
            mel_w = np.zeros((frames, self.cfg.mel.num_mels), np.float32)
        b = 1
        while True:
            group = [_Request(n, i, 1.0, None, mel_w) for i in range(b)]
            t0 = time.monotonic()
            self._decode_group(group)
            if verbose:
                print(f"warmup: batch bucket {b} compiled+ran "
                      f"in {time.monotonic() - t0:.1f}s", flush=True)
            if b >= self.max_batch:
                return
            b = min(b * 2, self.max_batch)

    def close(self, wait: bool = True) -> None:
        """Stop accepting requests; optionally drain in-flight work."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._inbox.put(_DONE)
            self._inbox_single.put(_DONE)
        if wait:
            for w in self._workers:
                w.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker ----

    def _collect(self, inbox):
        """Gather one microbatch group: first request fixes the group
        signature; compatible requests arriving within max_wait_s join.

        The conditioned lane batches MEL requests too
        (round 5 — the flagship-vocoder product path, where every request
        carries mel): rows upsample their own mel at their own exact
        length and zero-pad the FEATURE timeline to the group scan length
        (_decode_group), which cannot change any row's emitted prefix
        (per-row y + AR causality), so the replay contract holds.  Primed
        requests stay singletons (the prime has a request-specific
        length)."""
        first = inbox.get()
        if first is _DONE:
            return None
        if first.prime is not None:
            return [first]  # request-specific shape: singleton batch

        def sig(r):
            return (None if r.prime is not None else
                    (_bucket(r.num_samples, self.length_quantum),
                     r.temperature, r.mel is not None))

        s0 = sig(first)
        group = [first]
        deadline = _monotonic() + self.max_wait_s
        leftovers, saw_done = [], False
        while len(group) < self.max_batch:
            remaining = deadline - _monotonic()
            if remaining <= 0:
                break
            try:
                nxt = inbox.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _DONE:
                saw_done = True
                break
            if sig(nxt) == s0:
                group.append(nxt)
            else:
                leftovers.append(nxt)
        for r in leftovers:  # keep deferred requests ahead of shutdown
            inbox.put(r)
        if saw_done:
            inbox.put(_DONE)  # re-arm shutdown after the drain
        return group

    def _run(self, inbox):
        while True:
            group = self._collect(inbox)
            if group is None:
                return
            t0 = _monotonic()
            try:
                self._decode_group(group)
            except BaseException as e:  # surface to every waiting client
                for r in group:
                    r.error = e
            finally:
                self._bump("decode_seconds", _monotonic() - t0)
                for r in group:
                    r.chunks.put(_DONE)

    @property
    def realtime_factor(self) -> float:
        """Aggregate generated-audio seconds per wall second of decode
        (microbatching efficiency in one number; >1 keeps up with demand)."""
        with self._stats_lock:
            dt = self.stats["decode_seconds"]
            return (self.stats["samples_out"] / self.cfg.sample_rate / dt
                    if dt > 0 else 0.0)

    def _decode_group(self, group):
        n_real = len(group)
        scan_len = _bucket(max(r.num_samples for r in group),
                           self.length_quantum)
        B = _batch_bucket(n_real, self.max_batch)
        if self.mesh is not None:
            # rows shard over the data axis: bucket to a multiple of dp
            from wavenet_tpu.parallel.mesh import DATA_AXIS
            dp = self.mesh.shape.get(DATA_AXIS, 1)
            B = max(B, dp)
            B = ((B + dp - 1) // dp) * dp
        self._bump("batches")
        self._bump("padded_rows", B - n_real)

        # per-REQUEST sampling seeds: row i draws noise keyed by ITS seed
        # only (ops/rng.py), so co-batched traffic and pad rows can never
        # change a response (replay contract; pad rows use seed 0)
        seeds = np.asarray([r.seed for r in group] + [0] * (B - n_real),
                           np.int32)

        speaker = None
        if self.cfg.global_classes is not None:
            ids = [0 if r.speaker is None else r.speaker for r in group]
            speaker = np.asarray(ids + [0] * (B - n_real), np.int32)

        # prime FIRST: it fixes the scan length (singleton, exact) and the
        # conditioning span the mel branch below must cover
        prime_tokens = None
        P = 0
        if group[0].prime is not None:
            from wavenet_tpu.audio import mulaw
            prime_tokens = mulaw.encode_np(
                group[0].prime, self.cfg.quantization_channels)[None]
            P = prime_tokens.shape[1]
            scan_len = group[0].num_samples  # singleton: exact length

        y = None
        if group[0].mel is not None:
            # BATCHED vocoder decode (round 5): each row's mel upsamples at
            # that row's own exact timeline (max(P-1,0)+num_samples, the
            # facade's _upsampled_cond rule) — bit-identical to its
            # singleton replay (WaveNet.stream(batch=1, mel=...,
            # seeds=[seed])) — then the feature timeline zero-pads to the
            # common scan length.  Padded steps lie beyond the row's
            # emitted prefix, and AR causality means later steps cannot
            # change earlier tokens, so co-batching cannot alter any
            # response.  Upsampling stays PER ROW (a batched conv could
            # round differently and break the bit-replay contract) but
            # runs through a cached jit, not op-by-op dispatch.
            import jax.numpy as jnp
            span = max(P - 1, 0)
            total = span + scan_len
            rows = []
            for r in group:
                y_r = self._upsample_jit(jnp.asarray(r.mel[None]),
                                         span + r.num_samples)
                rows.append(jnp.pad(
                    y_r, ((0, 0), (0, total - y_r.shape[1]), (0, 0))))
            if B > n_real:
                rows.append(jnp.zeros(
                    (B - n_real, total, self.cfg.mel.num_mels),
                    jnp.float32))
            # DEVICE-resident end to end: y is ~hop*M bytes per emitted
            # sample (82 MB for a 16 audio-second group — 80x the mel it
            # came from).  Only the ~KB mel crosses host->device; y is
            # built, padded, and sliced per chunk on the device.
            y = jnp.concatenate(rows, axis=0)

        if self.mesh is not None:
            self._decode_mesh(group, B, scan_len, seeds, speaker, y,
                              prime_tokens)
            return

        emitted = [0] * n_real
        for chunk in self.model.stream(
                num_samples=scan_len, chunk_samples=self.chunk_samples,
                batch=B, seeds=seeds, y=y, speaker=speaker,
                prime_tokens=prime_tokens,
                temperature=group[0].temperature):
            chunk = np.asarray(chunk, np.float32)
            for i, r in enumerate(group):
                take = min(chunk.shape[1], r.num_samples - emitted[i])
                if take > 0:
                    r.chunks.put(chunk[i, :take])
                    emitted[i] += take
                    self._bump("samples_out", take)
            if all(emitted[i] >= group[i].num_samples
                   for i in range(n_real)):
                break  # bucket tail serves nobody; stop the scan early

    def _decode_mesh(self, group, B, scan_len, seeds, speaker, y,
                     prime_tokens):
        """STREAMING distributed decode of the whole microbatch over the
        mesh: chunks flow to every request as they are produced (same
        time-to-first-audio contract as the single-device path), and the
        concatenation is bit-identical to a one-shot generate(mesh=...) at
        the same seeds (sampler.stream_distributed).  `y` is the batched
        per-row upsampled conditioning built by _decode_group (already B
        rows)."""
        if prime_tokens is not None and prime_tokens.shape[0] != B:
            prime_tokens = np.tile(np.asarray(prime_tokens), (B, 1))
        n_real = len(group)
        emitted = [0] * n_real
        for chunk in self.model.stream(
                num_samples=scan_len, chunk_samples=self.chunk_samples,
                batch=B, mesh=self.mesh, seeds=seeds,
                speaker=None if speaker is None else np.asarray(speaker),
                y=y, prime_tokens=prime_tokens,
                temperature=group[0].temperature):
            chunk = np.asarray(chunk, np.float32)
            for i, r in enumerate(group):
                take = min(chunk.shape[1], r.num_samples - emitted[i])
                if take > 0:
                    r.chunks.put(chunk[i, :take])
                    emitted[i] += take
                    self._bump("samples_out", take)
            if all(emitted[i] >= group[i].num_samples
                   for i in range(n_real)):
                break  # bucket tail serves nobody; stop the scan early


def _monotonic() -> float:
    import time
    return time.monotonic()
