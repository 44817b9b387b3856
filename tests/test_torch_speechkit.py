"""``thewhisper_tpu_torch.speechkit``: the reference's import names on the
port, used as the reference's examples use them (``tests/test_compat_shim.py``
pins the same names to the JAX package)."""

import numpy as np

import thestage_speechkit
from thewhisper_tpu_torch import pipeline, streaming, text
from thewhisper_tpu_torch import speechkit


def test_names_are_the_ports():
    assert speechkit.ASRPipeline is pipeline.ASRPipeline
    assert speechkit.StreamingPipeline is streaming.StreamingPipeline
    assert speechkit.TranscriptionBackend is streaming.TranscriptionBackend
    assert (speechkit.find_longest_common_sequence
            is text.find_longest_common_sequence)
    assert sorted(speechkit.__all__) == sorted(
        n for n in vars(speechkit) if not n.startswith("_")
        and n not in ("pipeline", "streaming", "text"))


def test_reference_style_streaming():
    """The reference's ``examples/run_streaming.py`` wiring on the port."""
    from thewhisper_tpu_torch.speechkit import (
        StreamingPipeline,
        TranscriptionBackend,
    )

    class Fake(TranscriptionBackend):
        def transcribe(self, audio, buffer_start_time, sample_rate):
            return [{"text": " ok", "start": buffer_start_time,
                     "end": buffer_start_time + 0.5}]

    sp = StreamingPipeline(backend=Fake(), chunk_length_s=10, use_vad=False)
    committed, uncommitted = sp(np.zeros(40000, np.float32))
    assert isinstance(committed, list) and isinstance(uncommitted, list)


def test_lcs_merge_as_the_shims():
    from thewhisper_tpu_torch.speechkit import find_longest_common_sequence

    for seqs in ([[1, 2, 3], [2, 3, 4]], [[5, 6], [7, 8]], [[1, 2, 3, 4]]):
        assert (find_longest_common_sequence(seqs)
                == thestage_speechkit.find_longest_common_sequence(seqs))
    assert find_longest_common_sequence([[1, 2, 3], [2, 3, 4]]) == [1, 2, 3, 4]
