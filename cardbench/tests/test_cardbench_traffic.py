"""The traffic generator: the same seed gives the same inputs, and every
seed the same sizes."""

import json

import numpy as np
import pytest
import torch

from conftest import BENCH


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["clips-bs64", "longform-bs32"])
def test_requests_repeat_per_seed(name):
    from harness.traffic import make_requests

    m = mix(name)
    if m["kind"] == "longform":
        m.update(length_s=30)
    big = 2**31 + 12345
    a, b = make_requests(m, big, "cpu"), make_requests(m, big, "cpu")
    c = make_requests(m, 5, "cpu")
    flat = lambda p: [r for call in p for r in call]
    assert all(np.array_equal(x.audio, y.audio) for x, y in zip(flat(a), flat(b)))
    # Same sizes, another order and other audio.
    assert sorted(x.seconds for x in flat(a)) == sorted(x.seconds for x in flat(c))
    assert not all(np.array_equal(x.audio[:100], y.audio[:100])
                   for x, y in zip(flat(a), flat(c)))
    for x in flat(a):
        assert x.audio.dtype == np.float32 and np.abs(x.audio).max() <= 1.0
        assert len(x.audio) == round(x.seconds * 16000)


def test_clip_calls_carry_the_same_audio():
    from harness.traffic import make_requests

    pool = make_requests(mix("clips-bs64"), 99, "cpu")
    totals = {round(sum(r.seconds for r in call), 6) for call in pool}
    assert len(totals) == 1
    lengths = [r.seconds for r in pool[0]]
    assert 1.0 <= min(lengths) and max(lengths) <= 30.0
    assert float(np.mean(lengths)) == pytest.approx(7.42, abs=0.01)


def test_speech_and_silence_alternates():
    from harness.traffic import speech_and_silence

    g = torch.Generator().manual_seed(0)
    x = speech_and_silence(20, g, "cpu").numpy()
    sec = np.abs(x).reshape(20, 16000).max(1)
    assert (sec[:5] > 0.05).all() and (sec[5:10] < 0.01).all()
    assert (sec[10:15] > 0.05).all() and (sec[15:] < 0.01).all()
