"""Plain Whisper in float32: the benchmark's reference for every Whisper
configuration.

It follows the published model (OpenAI's ``whisper/model.py`` and
Hugging Face's ``WhisperFeatureExtractor``): a log-mel front end (400-point
periodic Hann STFT, hop 160, reflect-padded, slaney mel bank to 8 kHz,
log10, clamp to max - 8, (x + 4) / 4), a conv stem with exact GELU,
sinusoidal positions, pre-LN encoder and decoder layers, the tied token
table as the readout. The decoder runs teacher-forced over whole token
rows with a causal mask; no cache, no kernel, no batching beyond the rows
it is given. It imports nothing of the program and takes only the state
dictionary the benchmark made (the port's key names) and the audio.

``numerics`` states how each product is computed. The default is exact
float32. A quantized configuration names what its program quantizes, and
the reference works the same quantization out again from the same float
weights: per-output-channel symmetric weights, per-row symmetric
activations, the token table per row, the cross K/V per channel over time,
each rounded half to even. The control (a lower precision than the
configuration states) is the same function with fewer bits or float8.

Set ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False before calling on the card
(``exact_float32``): TF32 would round every product's inputs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160

# numerics keys: "encoder_linear" and "decoder_linear" map to
# {"weight": bits, "act": bits} (a missing or None entry: float32), or
# "fp8" for float8 (e4m3) weights and activations; "table" and "cross_kv"
# map to bits, "fp8" or None.
EXACT: Dict[str, object] = {}


def exact_float32() -> None:
    """Turn TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) * 27.0 / np.log(6.4)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    lin = 200.0 * m / 3.0
    log = 1000.0 * np.exp(np.log(6.4) / 27.0 * (np.maximum(m, 15.0) - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filters(n_mels: int) -> np.ndarray:
    """(N_FFT // 2 + 1, n_mels) slaney-scale, slaney-normed triangles."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0),
                                   n_mels + 2))
    bank = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        lo, mid, hi = edges[i], edges[i + 1], edges[i + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        bank[i] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return bank.T.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, N) float32 audio, N a multiple of 160 -> (B, n_mels, N // 160)."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64,
                               device=audio.device).float()
    spec = torch.stft(audio.float(), N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.abs() ** 2                          # (B, 201, frames + 1)
    power = power[..., : audio.shape[-1] // HOP]
    bank = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    mel = torch.clamp_min(torch.einsum("bft,fm->bmt", power, bank), 1e-10)
    lm = torch.log10(mel)
    lm = torch.maximum(lm, lm.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (lm + 4.0) / 4.0


def fake_quant(x: torch.Tensor, kind, dim: int = -1) -> torch.Tensor:
    """x rounded as ``kind`` stores it, in float32: symmetric integers of
    ``kind`` bits scaled by the largest magnitude along ``dim``, or
    "fp8" (e4m3 scaled so that the largest magnitude is 448); None leaves
    x as it is."""
    x = x.float()
    if kind is None:
        return x
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8)
    if kind == "fp8":
        s = amax / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s
    qmax = 2 ** (int(kind) - 1) - 1
    s = amax / qmax
    return torch.round(x / s).clamp(-qmax, qmax) * s


class _Weights:
    """float32 views of the state, each weight rounded once as the
    numerics store it."""

    def __init__(self, state: Mapping[str, torch.Tensor], numerics, device):
        self.state, self.numerics, self.device = state, numerics, device
        self._cache: Dict[str, torch.Tensor] = {}

    def __call__(self, name: str, kind=None) -> torch.Tensor:
        key = f"{name}@{kind}"
        if key not in self._cache:
            w = self.state[name].to(self.device).float()
            self._cache[key] = fake_quant(w, kind) if kind is not None else w
        return self._cache[key]

    def drop(self) -> None:
        self._cache.clear()


def _spec(numerics, part: str):
    spec = numerics.get(part)
    if spec is None:
        return None, None
    if spec == "fp8":
        return "fp8", "fp8"
    return spec.get("weight"), spec.get("act")


def _linear(w: _Weights, prefix: str, x: torch.Tensor, part: str,
            bias: bool = True) -> torch.Tensor:
    wk, ak = _spec(w.numerics, part)
    y = fake_quant(x, ak) @ w(f"{prefix}.weight", wk).t()
    return y + w(f"{prefix}.bias") if bias else y


def _ln(w: _Weights, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w(f"{prefix}.weight"),
                        w(f"{prefix}.bias"), 1e-5)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.view(b, s, h, d // h).transpose(1, 2)


def _attend(q, k, v, mask=None):
    scores = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    b, h, s, dh = out.shape
    return out.transpose(1, 2).reshape(b, s, h * dh)


def encode(state, arch, mel: torch.Tensor, numerics=EXACT) -> torch.Tensor:
    """(B, n_mels, T_mel) features -> (B, T_mel // 2, d) encoder states."""
    w = _Weights(state, numerics, mel.device)
    x = F.gelu(F.conv1d(mel.float(), w("encoder.conv1.weight"),
                        w("encoder.conv1.bias"), padding=1))
    x = F.gelu(F.conv1d(x, w("encoder.conv2.weight"), w("encoder.conv2.bias"),
                        stride=2, padding=1)).transpose(1, 2)
    x = x + w("encoder.pos_emb")[: x.shape[1]]
    h = arch.encoder_heads
    for i in range(arch.encoder_layers):
        p = f"encoder.layers.{i}"
        a = _ln(w, f"{p}.ln1", x)
        q = _heads(_linear(w, f"{p}.attn.q", a, "encoder_linear"), h)
        k = _heads(_linear(w, f"{p}.attn.k", a, "encoder_linear", bias=False), h)
        v = _heads(_linear(w, f"{p}.attn.v", a, "encoder_linear"), h)
        x = x + _linear(w, f"{p}.attn.out", _attend(q, k, v), "encoder_linear")
        m = F.gelu(_linear(w, f"{p}.fc1", _ln(w, f"{p}.ln2", x), "encoder_linear"))
        x = x + _linear(w, f"{p}.fc2", m, "encoder_linear")
        w.drop()
    return _ln(w, "encoder.ln_post", x)


def decode_logits(state, arch, enc: torch.Tensor, tokens: torch.Tensor,
                  numerics=EXACT) -> torch.Tensor:
    """Teacher-forced logits (B, S, V) float32 of the token rows (B, S)
    at positions [0, S) over the encoder states (B, T, d)."""
    w = _Weights(state, numerics, enc.device)
    table_kind = numerics.get("table")
    kv_kind = numerics.get("cross_kv")
    table = w("decoder.token_emb", table_kind)
    s = tokens.shape[1]
    x = table[tokens] + w("decoder.pos_emb")[:s]
    causal = torch.ones(s, s, dtype=torch.bool, device=enc.device).tril()
    h = arch.decoder_heads
    for i in range(arch.decoder_layers):
        p = f"decoder.layers.{i}"
        a = _ln(w, f"{p}.ln1", x)
        q = _heads(_linear(w, f"{p}.self_attn.q", a, "decoder_linear"), h)
        k = _heads(_linear(w, f"{p}.self_attn.k", a, "decoder_linear", bias=False), h)
        v = _heads(_linear(w, f"{p}.self_attn.v", a, "decoder_linear"), h)
        x = x + _linear(w, f"{p}.self_attn.out", _attend(q, k, v, causal),
                        "decoder_linear")
        c = _ln(w, f"{p}.ln_cross", x)
        cq = _heads(_linear(w, f"{p}.cross_attn.q", c, "decoder_linear"), h)
        ck = _heads(_linear(w, f"{p}.cross_attn.k", enc, "decoder_linear",
                            bias=False), h)
        cv = _heads(_linear(w, f"{p}.cross_attn.v", enc, "decoder_linear"), h)
        # int8 cross K/V: a scale per (row, head, channel) over time.
        ck, cv = fake_quant(ck, kv_kind, dim=-2), fake_quant(cv, kv_kind, dim=-2)
        x = x + _linear(w, f"{p}.cross_attn.out", _attend(cq, ck, cv),
                        "decoder_linear")
        m = F.gelu(_linear(w, f"{p}.fc1", _ln(w, f"{p}.ln2", x), "decoder_linear"))
        x = x + _linear(w, f"{p}.fc2", m, "decoder_linear")
    x = _ln(w, "decoder.ln_post", x)
    _, act = _spec(numerics, "decoder_linear")
    readout_act = act if table_kind is not None else None
    return fake_quant(x, readout_act) @ table.t()


def numerics_for(mode: str, control: bool = False) -> Dict[str, object]:
    """The products of a configuration's ``mode`` ("bf16": float32 in the
    reference; "int8-all": the reference's "S"), or of its control, the
    nearest precision below the one the mode states: float8 (e4m3) for
    bfloat16, int4 for int8."""
    if mode == "bf16":
        if not control:
            return dict(EXACT)
        return {"encoder_linear": "fp8", "decoder_linear": "fp8",
                "table": "fp8", "cross_kv": "fp8"}
    if mode == "int8-all":
        b = 4 if control else 8
        return {"encoder_linear": {"weight": b, "act": b},
                "decoder_linear": {"weight": b},
                "table": b, "cross_kv": b}
    raise ValueError(f"no reference numerics for mode {mode!r}")


def readings(state, arch, audio: torch.Tensor, rows: torch.Tensor,
             prompt_len: int, allowed: int, numerics=EXACT,
             control: Optional[object] = None, block: int = 4
             ) -> Dict[str, torch.Tensor]:
    """The reference's readings of rows served for ``audio`` (B, N): each
    row of ``rows`` (B, P + n) is its prompt, then the n tokens served.
    Teacher-forced at ``numerics``, over the allowed ids (below
    ``allowed``), each (B, n) float32 on the CPU:

    - ``gap``: by how much each served token's logit lies below the best;
    - ``logprob``: each served token's log-probability;
    - ``best``: the best log-probability at each served token's position.

    A position past a row's served tokens reads an infinite gap and best
    and a log-probability of minus infinity. With ``control`` (numerics),
    at each position of the same rows: ``control_gap``, the reference's
    gap of the token the control puts first, ``control_logprob``, the
    control's log-probability of the served token, and ``control_best``,
    the control's log-probability of the token it puts first."""
    out: Dict[str, list] = {}
    for lo in range(0, audio.shape[0], block):
        a, r = audio[lo: lo + block], rows[lo: lo + block]
        served = r[:, prompt_len:]
        ok = served < allowed
        idx = served.clamp(max=allowed - 1)[..., None]
        mel = log_mel(a, arch.n_mels)
        logits = decode_logits(state, arch, encode(state, arch, mel, numerics),
                               r[:, :-1], numerics)[:, prompt_len - 1:, :allowed]
        best = logits.amax(dim=-1)
        inf = torch.full_like(best, float("inf"))
        lsm = torch.log_softmax(logits, -1)
        got = {"gap": torch.where(ok, best - logits.gather(-1, idx)[..., 0], inf),
               "logprob": torch.where(ok, lsm.gather(-1, idx)[..., 0], -inf),
               "best": torch.where(ok, lsm.amax(dim=-1), inf)}
        if control is not None:
            lc = decode_logits(state, arch, encode(state, arch, mel, control),
                               r[:, :-1], control)[:, prompt_len - 1:, :allowed]
            pick = lc.argmax(dim=-1, keepdim=True)
            lsc = torch.log_softmax(lc, -1)
            got["control_gap"] = best - logits.gather(-1, pick)[..., 0]
            got["control_logprob"] = torch.where(
                ok, lsc.gather(-1, idx)[..., 0], -inf)
            got["control_best"] = lsc.gather(-1, pick)[..., 0]
            del lc, lsc
        for k, v in got.items():
            out.setdefault(k, []).append(v.cpu())
        del mel, logits, lsm
    return {k: torch.cat(v) for k, v in out.items()}
