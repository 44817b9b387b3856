from thewhisper_tpu_torch.engine.engine import EngineResult, WhisperEngine  # noqa: F401
