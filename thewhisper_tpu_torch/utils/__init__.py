from thewhisper_tpu_torch.utils.wer import (  # noqa: F401
    edit_stats,
    wer,
    cer,
    align_words,
)
from thewhisper_tpu_torch.utils.normalizers import (  # noqa: F401
    BasicTextNormalizer,
    EnglishTextNormalizer,
)
