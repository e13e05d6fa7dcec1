from repro_torch.models.model import (  # noqa: F401
    abstract_caches,
    abstract_params,
    chunk_prefill_fn,
    decode_fn,
    init_caches,
    init_params,
    loss_fn,
    make_train_batch,
    prefill_fn,
)
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts  # noqa: F401
