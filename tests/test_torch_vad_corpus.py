"""The port's VAD corpora (``streaming/vad_corpus.py``,
``streaming/vad_holdout.py``) against the JAX package's, clip for clip and
bit for bit on the same seeds, and the port's ``NeuralVAD`` held on them to
the precision and recall that ``tests/test_vad.py`` holds JAX's to, its
probabilities within 1e-6 of JAX's."""

import numpy as np
import pytest

from thewhisper_tpu.streaming import vad as jax_vad
from thewhisper_tpu.streaming import vad_corpus as jax_corpus
from thewhisper_tpu.streaming import vad_holdout as jax_holdout
from thewhisper_tpu_torch.streaming import vad, vad_corpus, vad_holdout

from _torch_tiny import one_cpu_thread  # noqa: F401

WINDOW = vad_corpus.WINDOW
# tests/test_vad.py's seeds and clip counts: the held-out seed of the
# training family, and the out-of-family holdout.
CORPORA = {"corpus": (4242, 40), "holdout": (20260818, 30)}


def _clips(pkg_corpus, pkg_holdout, name):
    seed, n = CORPORA[name]
    if name == "corpus":
        return list(pkg_corpus.corpus(seed, n))
    return list(pkg_holdout.holdout_corpus(seed, n))


def _probs(model, clips):
    """The VAD's probability for every window, its state reset each clip."""
    out = []
    for audio, labels, _ in clips:
        model.reset_states()
        out.append(np.array([model(audio[w * WINDOW: (w + 1) * WINDOW], 16000)
                             for w in range(len(labels))]))
    return out


def _precision_recall(probs, clips, threshold):
    tp = fp = fn = 0
    for p, (_, labels, mask) in zip(probs, clips):
        live = mask != 0
        pred = p[live] > threshold
        speech = labels[live] != 0
        tp += int((pred & speech).sum())
        fp += int((pred & ~speech).sum())
        fn += int((~pred & speech).sum())
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


@pytest.fixture(scope="module", params=sorted(CORPORA))
def scored(request):
    name = request.param
    clips = _clips(vad_corpus, vad_holdout, name)
    return name, clips, _probs(vad.NeuralVAD(), clips)


def test_corpora_equal_jax(scored):
    name, clips, _ = scored
    theirs = _clips(jax_corpus, jax_holdout, name)
    assert len(clips) == len(theirs) == CORPORA[name][1]
    for ours, ref in zip(clips, theirs):
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    if name == "holdout":
        for snr in (10.0, 0.0):
            for a, b in zip(vad_holdout.holdout_corpus(7, 3, snr_db=snr),
                            jax_holdout.holdout_corpus(7, 3, snr_db=snr)):
                assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_neural_vad_meets_jax_thresholds(scored):
    """tests/test_vad.py:62-67 on the corpus (recall >= 0.97 and precision
    >= 0.90 at 0.1; recall >= 0.95 and precision >= 0.93 at 0.5) and
    :168-169 on the holdout (recall >= 0.80, precision >= 0.82 at 0.1)."""
    name, clips, probs = scored
    prec, rec = _precision_recall(probs, clips, 0.1)
    if name == "corpus":
        assert rec >= 0.97 and prec >= 0.90, (prec, rec)
        prec5, rec5 = _precision_recall(probs, clips, 0.5)
        assert rec5 >= 0.95 and prec5 >= 0.93, (prec5, rec5)
    else:
        assert rec >= 0.80 and prec >= 0.82, (prec, rec)


def test_neural_vad_probabilities_equal_jax(scored):
    """Every window of the first ten clips of each corpus."""
    _, clips, probs = scored
    theirs = _probs(jax_vad.NeuralVAD(), clips[:10])
    for p, q in zip(probs, theirs):
        np.testing.assert_allclose(p, q, rtol=0, atol=1e-6)
