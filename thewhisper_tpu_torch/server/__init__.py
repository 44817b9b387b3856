from thewhisper_tpu_torch.server.http import StreamingServer, SessionManager  # noqa: F401
