from thewhisper_tpu_torch.models.whisper import (  # noqa: F401
    DecodeCache,
    Whisper,
    compute_cross_kv,
    decoder_prefill,
    decoder_step,
    decoder_verify,
    encoder_forward,
    init_params,
    make_cache,
)
from thewhisper_tpu_torch.models.load import (  # noqa: F401
    load_checkpoint,
    params_from_jax,
)
