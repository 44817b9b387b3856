"""The reference's import names on the port.

User code written for TheStageAI/TheWhisper imports ``ASRPipeline`` from
``thestage_speechkit.nvidia`` (or ``.apple``), ``StreamingPipeline`` from
``thestage_speechkit.streaming`` and ``find_longest_common_sequence`` from
``thestage_speechkit``. On the GPU port those names come from here::

    from thewhisper_tpu_torch.speechkit import ASRPipeline, StreamingPipeline

(``thestage_speechkit`` itself maps them onto the JAX package.)
"""

from thewhisper_tpu_torch.pipeline import ASRPipeline
from thewhisper_tpu_torch.streaming import StreamingPipeline, TranscriptionBackend
from thewhisper_tpu_torch.text import find_longest_common_sequence

__all__ = ["ASRPipeline", "StreamingPipeline", "TranscriptionBackend",
           "find_longest_common_sequence"]
