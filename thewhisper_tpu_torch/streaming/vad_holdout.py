"""Held-out, OUT-OF-FAMILY eval corpus for the shipped NeuralVAD (the
port's own copy of thewhisper_tpu's ``streaming/vad_holdout.py``; the same
clips from the same seeds).

A held-out seed of the generator family the VAD was trained on
(``vad_corpus.py``) is self-referential. No real audio exists in this image (neither repo nor
reference ships a WAV and there is no egress), so the strongest available
validation is a *generator-family* transfer test: every synthesis recipe
here is acoustically disjoint from the training corpus.

Positives (vs. the trainer's fixed-formant pulse-train syllables):
Rosenberg-pulse glottal source with shimmer, CONTINUOUS formant
trajectories (vowel-target interpolation, coarticulated glides), speaker
profiles (male/female/child f0 ranges with declination), plosive
closures + bursts, and fully whispered utterances (noise-excited formant
filters — no periodicity cue at all).

Negatives (vs. the trainer's white/pink/hum/tones/clicks/AM-noise/
chirps/arpeggios): Karplus-Strong plucked-string music, rain (Poisson
shot noise), applause (clap train), machinery (harmonic stack with
20-60 Hz sideband AM — too fast for syllabic rates), gusty wind
(slowly-varied lowpass noise), and traffic-like rumble with passing
events.

The MUSAN-SNR protocol of the reference's robustness eval
(the reference's ``benchmark/data_utils.py:43-83``, clean/10/5/0 dB) is
mirrored by ``holdout_corpus(..., snr_db=...)``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from thewhisper_tpu_torch.streaming.vad_corpus import WINDOW, _resonator

SR = 16000

# (F1, F2, F3) targets, Hz — canonical vowel space corners + interior.
_VOWELS = (
    (730, 1090, 2440),   # /a/
    (270, 2290, 3010),   # /i/
    (300, 870, 2240),    # /u/
    (530, 1840, 2480),   # /e/
    (570, 840, 2410),    # /o/
    (660, 1720, 2410),   # /ae/
)

# (f0 low, f0 high, declination per second)
_SPEAKERS = {
    "male": (80.0, 140.0, 8.0),
    "female": (160.0, 260.0, 14.0),
    "child": (250.0, 400.0, 20.0),
}


def _rosenberg_source(rng: np.random.Generator, n: int, f0_curve: np.ndarray,
                      sr: int = SR) -> np.ndarray:
    """Rosenberg glottal pulse train: rising-falling flow derivative per
    period (open quotient ~0.6), with per-period shimmer. Nothing like the
    trainer's rectangular 10 %-duty pulse train."""
    phase = np.cumsum(f0_curve / sr)
    frac = np.mod(phase, 1.0)
    oq, cq = 0.45, 0.15                      # opening / closing quotients
    rising = frac < oq
    closing = (frac >= oq) & (frac < oq + cq)
    g = np.zeros(n, np.float32)
    g[rising] = 0.5 * (1 - np.cos(np.pi * frac[rising] / oq))
    g[closing] = np.cos(0.5 * np.pi * (frac[closing] - oq) / cq)
    # Shimmer: amplitude varies per period.
    period_id = np.floor(phase).astype(np.int64)
    shim = 1.0 + 0.15 * rng.standard_normal(int(period_id.max()) + 2)
    g = g * shim[period_id].astype(np.float32)
    # Differentiate (radiation characteristic) + slight aspiration.
    d = np.diff(g, prepend=0.0).astype(np.float32)
    return d + 0.01 * rng.standard_normal(n).astype(np.float32)


def holdout_speech(rng: np.random.Generator, seconds: float, sr: int = SR,
                   speaker: Optional[str] = None,
                   whispered: Optional[bool] = None,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Speech-like audio with per-sample activity mask (see module doc)."""
    n = int(seconds * sr)
    audio = np.zeros(n, np.float32)
    activity = np.zeros(n, np.float32)
    if speaker is None:
        speaker = list(_SPEAKERS)[int(rng.integers(0, len(_SPEAKERS)))]
    f0_lo, f0_hi, decl = _SPEAKERS[speaker]
    t = int(rng.uniform(0.0, 0.3) * sr)
    while t < n:
        # One "word": 2-6 vowel targets glided through continuously.
        n_targets = int(rng.integers(2, 7))
        dur = int(rng.uniform(0.12, 0.18) * sr) * n_targets
        dur = min(dur, n - t)
        if dur <= int(0.05 * sr):
            break
        whisper = (rng.random() < 0.25 if whispered is None else whispered)
        # Continuous formant trajectories through the vowel targets.
        targets = [_VOWELS[int(rng.integers(0, len(_VOWELS)))]
                   for _ in range(n_targets)]
        knots = np.linspace(0, dur - 1, n_targets)
        tt = np.arange(dur)
        formants = [np.interp(tt, knots, [v[k] for v in targets])
                    * rng.uniform(0.9, 1.1)
                    for k in range(3)]
        if whisper:
            src = rng.standard_normal(dur).astype(np.float32) * 0.5
        else:
            f0_start = rng.uniform(f0_lo, f0_hi)
            f0_curve = (f0_start * (1 + 0.08 * np.sin(
                2 * np.pi * rng.uniform(2, 5) * tt / sr))   # vibrato-ish
                - decl * tt / sr                            # declination
                + np.cumsum(rng.normal(0, 0.3, dur)) / sr * 50)  # jitter
            f0_curve = np.clip(f0_curve, 50.0, 450.0)
            src = _rosenberg_source(rng, dur, f0_curve, sr)
        seg = np.zeros(dur, np.float32)
        # Piecewise-constant formant filtering (16 ms blocks — resonator
        # coefficients follow the trajectory).
        blk = int(0.016 * sr)
        for b0 in range(0, dur, blk):
            b1 = min(b0 + blk, dur)
            sub = src[b0:b1]
            for k, bw in enumerate((70.0, 110.0, 170.0)):
                f = float(np.mean(formants[k][b0:b1]))
                seg[b0:b1] += _resonator(sub, f, bw, sr) * (0.8 ** k)
        # Word-level envelope with soft on/offsets; occasional plosive
        # closure + burst at the word start.
        env = np.ones(dur, np.float32)
        edge = max(int(0.02 * sr), 1)
        ramp = np.linspace(0, 1, edge, dtype=np.float32)
        env[:edge] *= ramp
        env[-edge:] *= ramp[::-1]
        if rng.random() < 0.4 and dur > int(0.06 * sr):
            closure = int(rng.uniform(0.02, 0.04) * sr)
            env[:closure] = 0.0
            burst_len = min(int(0.012 * sr), dur - closure)
            seg[closure: closure + burst_len] += (
                0.6 * np.diff(rng.standard_normal(burst_len + 1))
                .astype(np.float32)
                * np.exp(-np.arange(burst_len) / (0.004 * sr)))
        seg *= env
        peak = np.abs(seg).max() + 1e-9
        seg = seg / peak * rng.uniform(0.3, 1.0)
        audio[t: t + dur] += seg
        activity[t: t + dur] = np.maximum(
            activity[t: t + dur], (env > 0.1).astype(np.float32))
        t += dur
        t += int(rng.uniform(0.1, 0.8) * sr)   # inter-word pause
    return audio, activity


def _holdout_rir(rng: np.random.Generator, sr: int = SR) -> np.ndarray:
    """Two-slope RIR with discrete early reflections — a different room
    model from the trainer's single-slope noise tail."""
    rt = rng.uniform(0.15, 0.7)
    n = int(rt * sr)
    rir = np.zeros(n + 1, np.float32)
    rir[0] = 1.0
    for _ in range(int(rng.integers(3, 9))):      # early reflections
        p = int(rng.uniform(0.002, 0.03) * sr)
        if p < len(rir):
            rir[p] += rng.uniform(0.1, 0.5) * rng.choice([-1.0, 1.0])
    tail = rng.standard_normal(n).astype(np.float32)
    k = np.arange(n) / n
    # Two-slope decay: fast early, slower late.
    env = np.where(k < 0.25, np.exp(-12 * k), np.exp(-3 - 4 * (k - 0.25)))
    rir[1:] += rng.uniform(0.1, 0.4) * tail * env.astype(np.float32)
    return rir


def _convolve_same(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    m = len(x) + len(h) - 1
    nfft = 1 << (m - 1).bit_length()
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(h, nfft),
                     nfft)[: len(x)]
    return (y / (np.abs(y).max() + 1e-9) * (np.abs(x).max() + 1e-9)
            ).astype(np.float32)


N_NEG_KINDS = 8
NEG_KIND_NAMES = ("karplus-strong", "rain", "applause", "machinery",
                  "wind", "traffic", "speech-shaped-noise",
                  "aliased-machinery")


def holdout_negative(rng: np.random.Generator, seconds: float,
                     sr: int = SR, kind: Optional[int] = None) -> np.ndarray:
    """One MUSAN-style non-speech clip from a family the trainer never saw."""
    n = int(seconds * sr)
    if kind is None:
        kind = int(rng.integers(0, N_NEG_KINDS))
    if kind == 6:
        # Speech-shaped modulated noise, round-5 eval recipe (distinct
        # from the trainer's fixed-resonator sinusoid-AM version):
        # THREE random-walking formant-range resonators over pink-ish
        # noise, AM from rectified 0.5-4 Hz band noise.
        from scipy.signal import lfilter

        src = lfilter([0.3], [1.0, -0.7],
                      rng.standard_normal(n)).astype(np.float32)
        y = np.zeros(n, np.float32)
        blk = int(0.03 * sr)
        centers = np.asarray([rng.uniform(300, 800),
                              rng.uniform(900, 2000),
                              rng.uniform(2100, 3200)])
        for b0 in range(0, n, blk):
            b1 = min(b0 + blk, n)
            centers = np.clip(centers * (1 + rng.normal(0, 0.04, 3)),
                              250, 3500)
            for c in centers:
                y[b0:b1] += _resonator(src[b0:b1], float(c), 150.0, sr)
        am_src = lfilter([0.01], [1.0, -0.999],
                         rng.standard_normal(n)).astype(np.float32)
        am = np.abs(am_src)
        am = am / (am.max() + 1e-9)
        y = y * (0.15 + 0.85 * am)
        return (rng.uniform(0.15, 0.5) * y / (np.abs(y).max() + 1e-9)
                ).astype(np.float32)
    if kind == 7:
        # Aliased/sample-held machinery: harmonic stack through a
        # sample-and-hold "codec" (decimation artifacts).
        tt = np.arange(n) / sr
        base = rng.uniform(120, 700)
        y = np.asarray(sum(
            rng.uniform(0.2, 1.0)
            * np.sin(2 * np.pi * base * k * tt + rng.uniform(0, 6.28))
            for k in range(1, 7)), np.float32)
        hold = int(rng.integers(3, 9))
        y = np.repeat(y[::hold], hold)[:n]
        bits = int(rng.integers(3, 6))                 # bit-crush
        q = 2.0 ** (bits - 1)
        y = np.round(y * q) / q
        return (rng.uniform(0.1, 0.4) * y / (np.abs(y).max() + 1e-9)
                ).astype(np.float32)
    if kind == 0:     # Karplus-Strong plucked string phrase
        y = np.zeros(n, np.float32)
        pos = 0
        while pos < n:
            f = rng.uniform(82, 660)
            period = max(int(sr / f), 2)
            dur = min(int(rng.uniform(0.2, 0.6) * sr), n - pos)
            buf = rng.standard_normal(period).astype(np.float32)
            # Cycle-vectorized KS: each period is the damped average of
            # the previous one (the classic update applied per cycle).
            cycles = []
            for _ in range(dur // period + 1):
                cycles.append(buf)
                buf = 0.5 * (buf + np.roll(buf, -1)) * 0.996
            out = np.concatenate(cycles)[:dur]
            y[pos: pos + dur] += out * rng.uniform(0.3, 0.9)
            # Never advance by 0 (dur shrinks to 1 at the clip end).
            pos += max(int(dur * rng.uniform(0.5, 1.0)), 1)
        return (0.4 * y / (np.abs(y).max() + 1e-9)).astype(np.float32)
    if kind == 1:     # rain: Poisson shot noise through a highpass
        y = np.zeros(n, np.float32)
        n_drops = int(seconds * rng.uniform(300, 1500))
        pos = rng.integers(0, max(n - 32, 1), n_drops)
        for p in pos:
            y[p: p + 32] += (rng.uniform(0.05, 0.3)
                             * np.exp(-np.arange(32) / 6.0)
                             * rng.standard_normal(32))
        return y.astype(np.float32)
    if kind == 2:     # applause: clap train (denser, band-passed claps)
        y = np.zeros(n, np.float32)
        n_claps = int(seconds * rng.uniform(8, 30))
        for _ in range(n_claps):
            p = int(rng.integers(0, max(n - 400, 1)))
            clap = rng.standard_normal(400).astype(np.float32)
            clap = _resonator(clap, rng.uniform(800, 2500), 600.0, sr)
            y[p: p + 400] += clap * np.exp(-np.arange(400) / 60.0) \
                * rng.uniform(0.2, 0.8)
        return (0.5 * y / (np.abs(y).max() + 1e-9)).astype(np.float32)
    if kind == 3:     # machinery: harmonic stack, 20-60 Hz sideband AM
        tt = np.arange(n) / sr
        base = rng.uniform(30, 90)
        y = sum(rng.uniform(0.2, 1.0)
                * np.sin(2 * np.pi * base * k * tt + rng.uniform(0, 6.28))
                for k in range(1, 9))
        am = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(20, 60) * tt)
        y = np.asarray(y * am, np.float32)
        return (rng.uniform(0.1, 0.4) * y / (np.abs(y).max() + 1e-9)
                ).astype(np.float32)
    if kind == 4:     # gusty wind: lowpass noise, 0.1-0.5 Hz gusts
        from scipy.signal import lfilter

        w = rng.standard_normal(n).astype(np.float32)
        y = lfilter([0.05], [1.0, -0.95], w).astype(np.float32)
        tt = np.arange(n) / sr
        gust = 0.4 + 0.6 * (0.5 - 0.5 * np.cos(
            2 * np.pi * rng.uniform(0.1, 0.5) * tt + rng.uniform(0, 6.28)))
        y = y * gust.astype(np.float32)
        return (rng.uniform(0.2, 0.6) * y / (np.abs(y).max() + 1e-9)
                ).astype(np.float32)
    # kind == 5: traffic rumble with a passing event (Doppler-ish swell)
    from scipy.signal import lfilter

    w = rng.standard_normal(n).astype(np.float32)
    y = lfilter([0.02], [1.0, -0.99], w).astype(np.float32)
    tt = np.arange(n) / sr
    center = rng.uniform(0.2, 0.8) * seconds
    swell = 1.0 + 2.0 * np.exp(-((tt - center) / rng.uniform(0.3, 1.0)) ** 2)
    y = y * swell.astype(np.float32)
    return (rng.uniform(0.2, 0.5) * y / (np.abs(y).max() + 1e-9)
            ).astype(np.float32)


def holdout_clip(rng: np.random.Generator, seconds: float = 4.0,
                 sr: int = SR, snr_db: Optional[float] = None,
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(audio, window labels, window mask) like ``vad_corpus.make_clip``.

    ``snr_db=None`` mixes speech over noise at a random 0-25 dB; a number
    pins the MUSAN protocol points (10/5/0). Pure-negative clips (no
    speech) appear with probability 0.4 regardless.
    """
    speech_present = rng.random() < 0.6
    noise = holdout_negative(rng, seconds, sr)
    if speech_present:
        speech, act = holdout_speech(rng, seconds, sr)
        if rng.random() < 0.3:
            # Reverberant speech-in-noise (round-5 eval axis): two-slope
            # room on the SPEECH; tails become ambiguous (0.5 activity ->
            # the 20-80 % boundary mask), never hard negatives.
            speech = _convolve_same(speech, _holdout_rir(rng, sr))
            k = int(0.12 * sr)
            ext = np.convolve(act, np.ones(k, np.float32),
                              mode="full")[: len(act)]
            act = np.maximum(act, 0.5 * (ext > 0).astype(np.float32))
        snr = float(rng.uniform(0.0, 25.0)) if snr_db is None else snr_db
        p_s = float(np.mean(speech ** 2)) + 1e-12
        p_n = float(np.mean(noise ** 2)) + 1e-12
        noise = noise * np.sqrt(p_s / (p_n * 10 ** (snr / 10)))
        audio = speech + noise
    else:
        audio, act = noise, np.zeros(len(noise), np.float32)
    r = rng.random()
    if r < 0.15:
        # Clipping artifact (round-5 eval axis).
        c = rng.uniform(0.3, 0.7) * (np.abs(audio).max() + 1e-9)
        audio = np.clip(audio, -c, c)
    elif r < 0.3:
        # Uniform bit-crush codec artifact (distinct from the trainer's
        # mu-law round trip).
        bits = int(rng.integers(4, 7))
        peak = np.abs(audio).max() + 1e-9
        q = 2.0 ** (bits - 1)
        audio = (np.round(audio / peak * q) / q * peak).astype(np.float32)
    n_win = len(audio) // WINDOW
    frac = act[: n_win * WINDOW].reshape(n_win, WINDOW).mean(axis=1)
    labels = (frac > 0.5).astype(np.float32)
    mask = ((frac < 0.2) | (frac > 0.8)).astype(np.float32)
    peak = np.abs(audio).max()
    if peak > 1.0:
        audio = audio / peak
    return audio[: n_win * WINDOW].astype(np.float32), labels, mask


def holdout_corpus(seed: int, n_clips: int, seconds: float = 4.0,
                   sr: int = SR, snr_db: Optional[float] = None,
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    for _ in range(n_clips):
        yield holdout_clip(rng, seconds, sr, snr_db=snr_db)
