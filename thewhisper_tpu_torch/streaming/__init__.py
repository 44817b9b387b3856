from thewhisper_tpu_torch.streaming.pipeline import (  # noqa: F401
    StreamingPipeline,
    TranscriptionBackend,
    LocalWhisperBackend,
    RemoteAPIBackend,
    RemoteAPITimestampsBackend,
)
from thewhisper_tpu_torch.streaming.streams import (  # noqa: F401
    ArrayStream,
    FileStream,
    MicStream,
    StdoutStream,
)
from thewhisper_tpu_torch.streaming.vad import EnergyVAD, make_vad  # noqa: F401
