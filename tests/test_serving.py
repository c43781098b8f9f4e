"""Serving layer (wavenet_tpu/serving): AOT decode artifacts + the
microbatching synthesis server.

The reference deploys by shipping HDF5 weights + model code rebuilt per
process (SURVEY.md §3.4); the counterparts here are a frozen
jax.export artifact and an engine that keeps one compiled decoder hot and
microbatches concurrent requests into it.  Covered:

  * AOT artifact round-trip: exported decode == live wn.generate, for
    unconditional and speaker-conditioned models; waveform() expands mu-law.
  * Server reproducibility contract: every row samples from the counter RNG
    keyed by ITS request seed (ops/rng.py) — a microbatch with seeds
    [s0..sk] is bit-identical to WaveNet.stream(seeds=[s0..sk]), and a
    request's audio is INDEPENDENT of what other traffic is co-batched
    with it (replayable via batch=1 + seeds=[its seed]).
  * Request padding/trimming: mixed lengths in one bucket each come back at
    their exact requested length; pad rows counted in stats.
  * Speaker routing, mel singleton path, and server-side error surfacing.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavenet_tpu.audio import mulaw
from wavenet_tpu.config import MelConfig, WaveNetConfig
from wavenet_tpu.models import wavenet as wn
from wavenet_tpu.models.api import WaveNet
from wavenet_tpu.serving import (WaveNetServer, export_decoder,
                                 load_decoder)


def cfg_(**kw):
    base = dict(num_blocks=1, max_dilation=8, residual_channels=16,
                skip_channels=16, compute_dtype="bfloat16",
                sample_rate=8000)
    base.update(kw)
    return WaveNetConfig(**base)


# ---------------------------------------------------------------- AOT

def test_aot_roundtrip_unconditional(tmp_path):
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "uncond.wnx")
    export_decoder(params, cfg, path, num_samples=32, batch=2)

    dec = load_decoder(path)
    assert dec.num_samples == 32 and dec.batch == 2
    key = jax.random.PRNGKey(5)
    got = np.asarray(dec.generate(key=key))
    want = np.asarray(wn.generate(params, cfg, key, 32, batch=2))
    np.testing.assert_array_equal(got, want)

    wav = dec.waveform(key=key)
    np.testing.assert_allclose(
        wav, mulaw.decode_np(want, cfg.quantization_channels))
    with pytest.raises(ValueError, match="speaker"):
        dec.generate(speaker=np.zeros((2,), np.int32))


def test_aot_multi_platform_export(tmp_path):
    """The default export cross-lowers for ("cpu", "cuda") once; the
    artifact still runs on the CPU backend and records both targets."""
    cfg = cfg_()
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "multi.wnx")
    export_decoder(params, cfg, path, num_samples=16, batch=1)
    dec = load_decoder(path)
    assert dec.platforms == ("cpu", "cuda")
    want = np.asarray(wn.generate(params, cfg, jax.random.PRNGKey(0), 16,
                                  batch=1))
    np.testing.assert_array_equal(np.asarray(dec.generate(seed=0)), want)


def test_aot_roundtrip_speaker(tmp_path):
    cfg = cfg_(global_classes=3, global_channels=8)
    params = wn.init_params(cfg, jax.random.PRNGKey(1))
    path = str(tmp_path / "spk.wnx")
    export_decoder(params, cfg, path, num_samples=24, batch=2)

    dec = load_decoder(path)
    assert dec.with_speaker
    key = jax.random.PRNGKey(3)
    sp = np.asarray([0, 2], np.int32)
    got = np.asarray(dec.generate(key=key, speaker=sp))
    want = np.asarray(wn.generate(params, cfg, key, 24, batch=2,
                                  speaker=jnp.asarray(sp)))
    np.testing.assert_array_equal(got, want)
    # default speaker is id 0
    d0 = np.asarray(dec.generate(key=key))
    w0 = np.asarray(wn.generate(params, cfg, key, 24, batch=2,
                                speaker=jnp.zeros((2,), jnp.int32)))
    np.testing.assert_array_equal(d0, w0)


# ---------------------------------------------------------------- server

def model_():
    cfg = cfg_()
    return WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(0)))


def test_aot_roundtrip_mel(tmp_path):
    """Round 5: mel-conditioned models export with a STATIC
    [batch, frames, M] conditioning input — the frozen vocoder artifact.
    Exported decode == live wn.generate on the same projected cond."""
    from wavenet_tpu.models.conditioning import prepare_decode_cond
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg)
    params = wn.init_params(cfg, jax.random.PRNGKey(0))
    N, B = 48, 2
    path = str(tmp_path / "voc.wnx")
    export_decoder(params, cfg, path, num_samples=N, batch=B)

    dec = load_decoder(path)
    assert dec.with_mel and dec.mel_frames == 3
    mel = np.random.default_rng(4).normal(size=(B, 3, 8)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    got = np.asarray(dec.generate(key=key, mel=mel))
    cond = prepare_decode_cond(params, cfg, jnp.asarray(mel), N)
    want = np.asarray(wn.generate(params, cfg, key, N, batch=B, cond=cond))
    np.testing.assert_array_equal(got, want)
    # 2-D mel broadcasts over the batch; wrong frame count is rejected
    got2 = np.asarray(dec.generate(key=key, mel=mel[0]))
    assert got2.shape == (B, N)
    with pytest.raises(ValueError, match="static export shape"):
        dec.generate(mel=np.zeros((B, 5, 8), np.float32))
    with pytest.raises(ValueError, match="pass mel="):
        dec.generate(seed=1)


def test_server_single_request_matches_stream():
    m = model_()
    with WaveNetServer(m, max_batch=1, max_wait_ms=1,
                       chunk_seconds=16 / 8000,
                       length_quantum_seconds=8 / 8000) as srv:
        wav = srv.synthesize(num_samples=40, seed=11)
    want = np.concatenate(
        [c[0] for c in m.stream(num_samples=40, chunk_samples=16,
                                batch=1, seeds=np.asarray([11]))])
    assert wav.shape == (40,)
    np.testing.assert_array_equal(wav, want)


def test_server_microbatch_reproducible_and_trimmed():
    """Two requests with different lengths in the same bucket decode as ONE
    batch reproducible via the documented per-request-seeds contract; each
    comes back trimmed to its own length."""
    m = model_()
    srv = WaveNetServer(m, max_batch=2, max_wait_ms=2000,
                        chunk_seconds=16 / 8000,
                        length_quantum_seconds=48 / 8000)
    try:
        h1 = srv.submit(num_samples=40, seed=1)
        h2 = srv.submit(num_samples=48, seed=2)
        w1, w2 = h1.waveform(), h2.waveform()
    finally:
        srv.close()
    assert w1.shape == (40,) and w2.shape == (48,)
    assert srv.stats["batches"] == 1 and srv.stats["padded_rows"] == 0

    ref = np.concatenate(
        [np.asarray(c) for c in m.stream(num_samples=48, chunk_samples=16,
                                         batch=2,
                                         seeds=np.asarray([1, 2]))],
        axis=1)
    np.testing.assert_array_equal(w1, ref[0, :40])
    np.testing.assert_array_equal(w2, ref[1, :48])


def test_request_replay_independent_of_cobatching():
    """THE per-request replay contract (round-2 verdict #3): re-submitting
    the same request in two different batch compositions — and solo —
    yields identical audio, because each row's noise is keyed by its own
    request seed, never by its neighbors or its row position."""
    m = model_()
    kw = dict(max_batch=4, max_wait_ms=2000, chunk_seconds=16 / 8000,
              length_quantum_seconds=32 / 8000)
    with WaveNetServer(m, **kw) as srv:
        hs = [srv.submit(num_samples=32, seed=s) for s in (7, 1, 9)]
        batched_a = [h.waveform() for h in hs]
    with WaveNetServer(m, **kw) as srv:
        # same request (seed 7) co-batched with DIFFERENT traffic, in a
        # different row position
        hs = [srv.submit(num_samples=32, seed=s) for s in (5, 7)]
        batched_b = [h.waveform() for h in hs]
    with WaveNetServer(m, max_batch=1, max_wait_ms=1,
                       chunk_seconds=16 / 8000,
                       length_quantum_seconds=32 / 8000) as srv:
        solo = srv.synthesize(num_samples=32, seed=7)
    np.testing.assert_array_equal(batched_a[0], batched_b[1])
    np.testing.assert_array_equal(batched_a[0], solo)


def test_server_pads_to_batch_bucket():
    """Three concurrent requests pad to a 4-row batch; outputs of the pad
    row are dropped and stats record it."""
    m = model_()
    srv = WaveNetServer(m, max_batch=4, max_wait_ms=2000,
                        chunk_seconds=16 / 8000,
                        length_quantum_seconds=32 / 8000)
    try:
        hs = [srv.submit(num_samples=32, seed=i) for i in range(3)]
        wavs = [h.waveform() for h in hs]
    finally:
        srv.close()
    assert all(w.shape == (32,) for w in wavs)
    assert srv.stats == {**srv.stats, "batches": 1, "padded_rows": 1,
                         "requests": 3, "samples_out": 96}


def test_server_speaker_rows_routed():
    cfg = cfg_(global_classes=3, global_channels=8)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(2)))
    srv = WaveNetServer(m, max_batch=2, max_wait_ms=2000,
                        chunk_seconds=16 / 8000,
                        length_quantum_seconds=32 / 8000)
    try:
        h1 = srv.submit(num_samples=32, seed=0, speaker=1)
        h2 = srv.submit(num_samples=32, seed=0, speaker=2)
        w1, w2 = h1.waveform(), h2.waveform()
    finally:
        srv.close()
    ref = np.concatenate(
        [np.asarray(c) for c in m.stream(
            num_samples=32, chunk_samples=16, batch=2,
            seeds=np.asarray([0, 0]),
            speaker=np.asarray([1, 2], np.int32))], axis=1)
    np.testing.assert_array_equal(w1, ref[0])
    np.testing.assert_array_equal(w2, ref[1])


def test_server_mel_request_and_coverage_error():
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(3)))
    frames = 3
    mel = np.random.default_rng(0).normal(
        size=(frames, mel_cfg.num_mels)).astype(np.float32)
    with WaveNetServer(m, max_batch=2, max_wait_ms=1,
                       chunk_seconds=16 / 8000) as srv:
        wav = srv.synthesize(num_samples=frames * mel_cfg.hop_length,
                             mel=mel, seed=4)
        assert wav.shape == (frames * mel_cfg.hop_length,)
        # num_samples beyond the mel coverage is rejected AT SUBMIT (a bad
        # request must not poison co-batched rows of its decode group)
        with pytest.raises(ValueError, match="mel frames"):
            srv.submit(num_samples=frames * mel_cfg.hop_length + 1,
                       mel=mel)
        # the server survives the rejected request
        assert srv.synthesize(num_samples=16, mel=mel).shape == (16,)


def test_server_mel_requests_batch_and_match_singleton_replay():
    """Round 5: compatible MEL requests batch on the conditioned lane —
    the flagship-vocoder product path — and each response is bit-identical
    to its singleton replay (WaveNet.stream(batch=1, mel=, seeds=[seed])),
    even at DIFFERENT lengths in one bucket (per-row upsampling + zero-
    padded feature timelines; AR causality keeps padding invisible)."""
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(3)))
    rng0 = np.random.default_rng(1)
    mels = [rng0.normal(size=(4, mel_cfg.num_mels)).astype(np.float32)
            for _ in range(3)]
    lens = [64, 48, 64]            # same length bucket (quantum 64)
    seeds = [11, 22, 33]
    with WaveNetServer(m, max_batch=4, max_wait_ms=200,
                       chunk_seconds=16 / 8000,
                       length_quantum_seconds=64 / 8000) as srv:
        hs = [srv.submit(num_samples=n, mel=mel, seed=s)
              for n, mel, s in zip(lens, mels, seeds)]
        wavs = [h.waveform() for h in hs]
        stats = dict(srv.stats)
    # all three decoded in ONE batch (the conditioned lane grouped them)
    assert stats["batches"] == 1, stats
    for wav, n, mel, s in zip(wavs, lens, mels, seeds):
        assert wav.shape == (n,)
        ref = np.concatenate(
            [np.asarray(c) for c in m.stream(
                num_samples=n, chunk_samples=16, batch=1,
                seeds=np.asarray([s]), mel=mel[None])], axis=1)
        np.testing.assert_array_equal(wav, ref[0])


def test_server_warmup_covers_buckets():
    m = model_()
    with WaveNetServer(m, max_batch=4, max_wait_ms=1,
                       chunk_seconds=16 / 8000,
                       length_quantum_seconds=16 / 8000) as srv:
        srv.warmup(seconds=16 / 8000)
        # buckets 1, 2, 4 -> 3 batches, no padding (direct groups,
        # not queued requests)
        assert srv.stats["batches"] == 3
        assert srv.stats["padded_rows"] == 0
        # the engine still serves normally afterwards
        assert srv.synthesize(num_samples=16, seed=1).shape == (16,)


def test_server_warmup_mel_model_uses_mel_rows():
    """On a mel-conditional model, warmup pushes MEL-carrying groups (the
    vocoder product load) through every bucket — compiling the
    conditioned-lane executables — and the engine serves both mel and
    unconditional traffic afterwards."""
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(3)))
    with WaveNetServer(m, max_batch=4, max_wait_ms=1,
                       chunk_seconds=16 / 8000,
                       length_quantum_seconds=16 / 8000) as srv:
        srv.warmup(seconds=16 / 8000)
        assert srv.stats["batches"] == 3          # buckets 1, 2, 4
        mel = np.zeros((2, 8), np.float32)
        assert srv.synthesize(num_samples=16, mel=mel).shape == (16,)
        assert srv.synthesize(num_samples=16, seed=1).shape == (16,)


def test_server_primed_request():
    """Priming runs as a singleton batch and matches WaveNet.stream with
    the same mu-law-encoded prime and fold-in key."""
    from wavenet_tpu.audio import mulaw
    m = model_()
    t = np.arange(24) / 8000.0
    prime_wave = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    with WaveNetServer(m, max_batch=4, max_wait_ms=1,
                       chunk_seconds=16 / 8000,
                       length_quantum_seconds=32 / 8000) as srv:
        wav = srv.synthesize(num_samples=40, seed=5, prime=prime_wave)
    assert wav.shape == (40,)

    pt = mulaw.encode_np(prime_wave, m.cfg.quantization_channels)[None]
    ref = np.concatenate(
        [np.asarray(c) for c in m.stream(num_samples=40, chunk_samples=16,
                                         batch=1, seeds=np.asarray([5]),
                                         prime_tokens=pt)], axis=1)
    np.testing.assert_array_equal(wav, ref[0])


def test_server_rejects_bad_submissions():
    m = model_()
    with WaveNetServer(m, max_wait_ms=1) as srv:
        with pytest.raises(ValueError, match="speaker"):
            srv.submit(num_samples=8, speaker=1)
        with pytest.raises(ValueError, match="mel"):
            srv.submit(num_samples=8, mel=np.zeros((2, 8), np.float32))
        with pytest.raises(ValueError, match="seconds"):
            srv.submit()
        with pytest.raises(ValueError, match="positive"):
            srv.submit(num_samples=0)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(num_samples=8)


def test_server_rejects_out_of_range_speaker():
    """XLA gathers clamp out-of-range ids silently; the server must reject
    them instead of synthesizing the wrong speaker."""
    cfg = cfg_(global_classes=3, global_channels=8)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(0)))
    with WaveNetServer(m, max_wait_ms=1) as srv:
        with pytest.raises(ValueError, match="out of range"):
            srv.submit(num_samples=8, speaker=3)
        with pytest.raises(ValueError, match="out of range"):
            srv.submit(num_samples=8, speaker=-1)
        assert srv.synthesize(num_samples=8, speaker=2).shape == (8,)


def test_response_stream_one_shot_and_composable():
    """Partial consumption composes (first chunk + waveform() rest); an
    exhausted stream never blocks — repeat reads yield nothing."""
    m = model_()
    with WaveNetServer(m, max_batch=1, max_wait_ms=1,
                       chunk_seconds=16 / 8000,
                       length_quantum_seconds=8 / 8000) as srv:
        h = srv.submit(num_samples=40, seed=11)
        it = iter(h)
        first = next(it)
        rest = h.waveform()
        assert first.shape == (16,) and rest.shape == (24,)
        # exhausted: no hang, empty results
        assert list(h) == []
        assert h.waveform().shape == (0,)

        want = srv.synthesize(num_samples=40, seed=11)
    np.testing.assert_array_equal(np.concatenate([first, rest]), want)


def test_http_front_end():
    """stdlib HTTP wrapper: /healthz, /info, /synthesize (wav + chunked
    PCM stream + error mapping) against a live ephemeral-port server."""
    import io as io_mod
    import json
    import urllib.error
    import urllib.request
    import wave as wave_mod

    from wavenet_tpu.serving.http import make_server

    m = model_()
    engine = WaveNetServer(m, max_batch=2, max_wait_ms=5,
                           chunk_seconds=16 / 8000,
                           length_quantum_seconds=32 / 8000)
    server = make_server(engine, port=0)
    host, port = server.server_address[:2]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz") as r:
            assert json.loads(r.read()) == {"ok": True}
        with urllib.request.urlopen(base + "/info") as r:
            info = json.loads(r.read())
        assert info["sample_rate"] == 8000 and info["mel"] is False
        assert "realtime_factor" in info and "decode_seconds" in info["stats"]

        body = json.dumps({"num_samples": 32, "seed": 3}).encode()
        with urllib.request.urlopen(
                urllib.request.Request(base + "/synthesize", data=body)) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            with wave_mod.open(io_mod.BytesIO(r.read())) as w:
                assert w.getframerate() == 8000
                assert w.getnframes() == 32
                pcm = np.frombuffer(w.readframes(32), "<i2")

        body = json.dumps({"num_samples": 32, "seed": 3,
                           "stream": True}).encode()
        with urllib.request.urlopen(
                urllib.request.Request(base + "/synthesize", data=body)) as r:
            assert r.headers["Content-Type"] == "audio/L16"
            assert int(r.headers["X-Sample-Rate"]) == 8000
            assert int(r.headers["X-Num-Samples"]) == 32
            streamed = np.frombuffer(r.read(), "<i2")
        # same seed through the same engine: PCM identical across modes
        np.testing.assert_array_equal(streamed, pcm)

        # bad requests map to 400, not dropped connections
        for bad in ({"num_samples": 8, "speaker": 1},       # no global cond
                    {"num_samples": [8]},                   # wrong type
                    {"temperature": None, "seconds": 0.1},  # wrong type
                    "not an object"):
            data = json.dumps(bad).encode()
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    urllib.request.Request(base + "/synthesize", data=data))
            assert ei.value.code == 400, bad
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope")
        assert ei.value.code == 404

        # keep-alive stays usable after an error response with a body:
        # the handler must drain unread POST bodies (HTTP/1.1 framing)
        import http.client
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("POST", "/wrongpath",
                     body=json.dumps({"seconds": 1.0}).encode())
        r1 = conn.getresponse()
        assert r1.status == 404
        r1.read()
        conn.request("POST", "/synthesize",
                     body=json.dumps({"num_samples": 16}).encode())
        r2 = conn.getresponse()
        assert r2.status == 200 and len(r2.read()) > 44
        conn.close()
    finally:
        server.shutdown()
        engine.close(wait=False)


def test_server_mel_plus_prime_matches_facade():
    """mel AND prime on one request (documented composable over HTTP): the
    conditioning timeline must span the priming steps (max(P-1,0)+N — the
    round-5 review found the batched-mel rewrite dropped the span), and
    the reply must equal the facade's singleton stream with the same
    prime/mel/seed."""
    from wavenet_tpu.audio import mulaw
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(3)))
    P, N = 24, 48
    t = np.arange(P) / 8000.0
    prime_wave = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    frames = -(-(P - 1 + N) // mel_cfg.hop_length)       # covers P-1+N
    mel = np.random.default_rng(5).normal(
        size=(frames, mel_cfg.num_mels)).astype(np.float32)
    with WaveNetServer(m, max_batch=2, max_wait_ms=1,
                       chunk_seconds=16 / 8000,
                       length_quantum_seconds=32 / 8000) as srv:
        wav = srv.synthesize(num_samples=N, mel=mel, prime=prime_wave,
                             seed=6)
    assert wav.shape == (N,)
    pt = mulaw.encode_np(prime_wave, cfg.quantization_channels)[None]
    ref = np.concatenate(
        [np.asarray(c) for c in m.stream(num_samples=N, chunk_samples=16,
                                         batch=1, seeds=np.asarray([6]),
                                         prime_tokens=pt, mel=mel[None])],
        axis=1)
    np.testing.assert_array_equal(wav, ref[0])
    # coverage validation includes the priming span: mel that covers N but
    # not P-1+N is rejected at submit
    short = mel[:N // mel_cfg.hop_length + 1]
    with WaveNetServer(m, max_batch=2, max_wait_ms=1) as srv:
        with pytest.raises(ValueError, match="priming"):
            srv.submit(num_samples=N, mel=short, prime=prime_wave)


def test_server_rejects_malformed_mel_at_submit():
    """Wrong bin count / bad rank raise ValueError AT SUBMIT (engine API,
    not just HTTP) so a malformed request can never join — and poison — a
    batched decode group."""
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(3)))
    with WaveNetServer(m, max_batch=2, max_wait_ms=1) as srv:
        for bad in (np.zeros((3, 5), np.float32),      # wrong bins
                    np.zeros((8,), np.float32),        # 1-D
                    np.zeros((2, 3, 8), np.float32)):  # batch > 1
            with pytest.raises(ValueError, match="mel must be"):
                srv.submit(num_samples=16, mel=bad)
        # the engine still serves valid mel afterwards
        ok = np.zeros((2, 8), np.float32)
        assert srv.synthesize(num_samples=16, mel=ok).shape == (16,)


def test_http_vocoder_mel_request():
    """Round 5: the HTTP surface carries the vocoder product — mel as a
    JSON list OR base64-packed f32 rows; both produce the same audio as
    the in-process engine at the same seed; malformed mel maps to 400."""
    import base64
    import io as io_mod
    import json
    import urllib.error
    import urllib.request
    import wave as wave_mod

    from wavenet_tpu.serving.http import make_server

    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(3)))
    mel = np.random.default_rng(2).normal(size=(3, 8)).astype(np.float32)
    engine = WaveNetServer(m, max_batch=2, max_wait_ms=5,
                           chunk_seconds=16 / 8000)
    server = make_server(engine, port=0)
    host, port = server.server_address[:2]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://{host}:{port}"
    n = 48
    try:
        want = engine.synthesize(num_samples=n, mel=mel, seed=7)
        for body in (
                {"num_samples": n, "seed": 7, "mel": mel.tolist()},
                {"num_samples": n, "seed": 7,
                 "mel_b64": base64.b64encode(
                     mel.astype("<f4").tobytes()).decode()},
        ):
            req = urllib.request.Request(base + "/synthesize",
                                         data=json.dumps(body).encode())
            with urllib.request.urlopen(req) as r:
                with wave_mod.open(io_mod.BytesIO(r.read())) as w:
                    assert w.getnframes() == n
                    pcm = np.frombuffer(w.readframes(n), "<i2")
            ref = (np.clip(want, -1, 1) * 32767.0).astype("<i2")
            np.testing.assert_array_equal(pcm, ref)
        # malformed mel -> 400 (wrong bin count / bad base64 / both forms)
        for bad in ({"num_samples": n, "mel": [[0.0] * 5] * 3},
                    {"num_samples": n, "mel_b64": "%%%"},
                    {"num_samples": n, "mel": mel.tolist(),
                     "mel_b64": "QUJD"}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    base + "/synthesize", data=json.dumps(bad).encode()))
            assert ei.value.code == 400, bad
    finally:
        server.shutdown()
        engine.close(wait=False)


def test_server_mesh_mode_matches_distributed_generate():
    """mesh= routes microbatches through the distributed AR decoder
    (SURVEY.md P3); rows pad to a dp multiple and outputs replay via the
    per-request-seeds contract on the virtual CPU mesh."""
    from wavenet_tpu.audio import mulaw
    from wavenet_tpu.parallel.mesh import make_mesh

    cfg = cfg_(data_parallel=2, model_parallel=2)
    m = WaveNet(cfg).init()
    mesh = make_mesh(cfg)
    srv = WaveNetServer(m, max_batch=4, max_wait_ms=2000,
                        length_quantum_seconds=32 / 8000, mesh=mesh)
    try:
        h1 = srv.submit(num_samples=32, seed=4)
        h2 = srv.submit(num_samples=24, seed=9)
        h3 = srv.submit(num_samples=32, seed=2)
        w = [h.waveform() for h in (h1, h2, h3)]
    finally:
        srv.close()
    assert [x.shape for x in w] == [(32,), (24,), (32,)]
    # 3 requests pad to the 4-row bucket (already a dp=2 multiple)
    assert srv.stats["batches"] == 1 and srv.stats["padded_rows"] == 1

    toks = m.generate(num_samples=32, batch=4, mesh=mesh,
                      seeds=np.asarray([4, 9, 2, 0]))
    ref = mulaw.decode_np(np.asarray(toks), cfg.quantization_channels)
    np.testing.assert_array_equal(w[0], ref[0].astype(np.float32))
    np.testing.assert_array_equal(w[1], ref[1, :24].astype(np.float32))
    np.testing.assert_array_equal(w[2], ref[2].astype(np.float32))
    # row 1's audio replays SOLO on a 1-row mesh batch (seed 9 alone)
    solo = m.generate(num_samples=24, batch=2, mesh=mesh,
                      seeds=np.asarray([9, 0]))
    np.testing.assert_array_equal(np.asarray(toks)[1, :24],
                                  np.asarray(solo)[0])


def test_singleton_lane_does_not_block_batchable():
    """Round-2 verdict #6: a long dynamic-shape (mel) request runs on its
    own decode lane, so a batchable request submitted AFTER it completes
    while the mel decode is still in flight instead of queueing behind
    it."""
    import time as time_mod
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(3)))
    frames = 256                      # ~4096-sample mel decode: long on CPU
    mel = np.random.default_rng(0).normal(
        size=(frames, mel_cfg.num_mels)).astype(np.float32)
    with WaveNetServer(m, max_batch=2, max_wait_ms=1,
                       chunk_seconds=16 / 8000,
                       length_quantum_seconds=32 / 8000) as srv:
        # warm both executables so the ordering assertion measures decode,
        # not compilation
        srv.synthesize(num_samples=mel_cfg.hop_length * frames,
                       mel=mel, seed=1)
        srv.synthesize(num_samples=32, seed=1)

        done = {}
        h_mel = srv.submit(num_samples=mel_cfg.hop_length * frames,
                           mel=mel, seed=2)
        h_fast = srv.submit(num_samples=32, seed=2)

        def consume(name, h):
            h.waveform()
            done[name] = time_mod.monotonic()

        ts = [threading.Thread(target=consume, args=(n, h))
              for n, h in (("mel", h_mel), ("fast", h_fast))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    assert done["fast"] < done["mel"], (
        "batchable request queued behind the singleton mel decode")


def test_server_mesh_mode_mel_batch_matches_single_chip():
    """Mesh-mode serving of a BATCHED mel group (round 5): y shards with
    the rows over the data axis and the replies equal the single-chip
    engine's at the same seeds (the layout-independence contract)."""
    from wavenet_tpu.parallel.mesh import make_mesh
    mel_cfg = MelConfig(num_mels=8, hop_length=16, win_length=64,
                        fmax=4000.0, upsample_factors=(4, 4))
    cfg = cfg_(mel=mel_cfg, data_parallel=2)
    m = WaveNet(cfg, wn.init_params(cfg, jax.random.PRNGKey(3)))
    mesh = make_mesh(cfg)
    mel = np.random.default_rng(8).normal(size=(3, 8)).astype(np.float32)
    n = 32

    def serve(mesh_):
        with WaveNetServer(m, max_batch=2, max_wait_ms=2000,
                           chunk_seconds=16 / 8000,
                           length_quantum_seconds=32 / 8000,
                           mesh=mesh_) as srv:
            h1 = srv.submit(num_samples=n, mel=mel, seed=4)
            h2 = srv.submit(num_samples=n, mel=mel, seed=9)
            out = [h1.waveform(), h2.waveform()]
            stats = dict(srv.stats)
        return out, stats

    mesh_out, mesh_stats = serve(mesh)
    solo_out, _ = serve(None)
    assert mesh_stats["batches"] == 1          # the pair decoded together
    for a, b in zip(mesh_out, solo_out):
        np.testing.assert_array_equal(a, b)


def test_server_concurrent_consumers():
    """Chunks stream to consumers on other threads while the worker is
    still decoding; close(wait=True) drains everything submitted."""
    m = model_()
    srv = WaveNetServer(m, max_batch=2, max_wait_ms=50,
                        chunk_seconds=16 / 8000,
                        length_quantum_seconds=32 / 8000)
    out = {}

    def consume(name, h):
        out[name] = h.waveform()

    threads = []
    handles = [(f"r{i}", srv.submit(num_samples=32, seed=i))
               for i in range(4)]
    for name, h in handles:
        t = threading.Thread(target=consume, args=(name, h))
        t.start()
        threads.append(t)
    srv.close(wait=True)
    for t in threads:
        t.join(timeout=30)
    assert all(out[f"r{i}"].shape == (32,) for i in range(4))
    assert srv.stats["requests"] == 4
