from repro_torch.data.pipeline import Pipeline, to_device  # noqa: F401
from repro_torch.data.synthetic import DataConfig, data_config_for, \
    sample_batch, sample_batch_plain, stream  # noqa: F401
