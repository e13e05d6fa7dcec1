from repro_torch.serving.clock import Clock, VirtualClock, WallClock  # noqa: F401
from repro_torch.serving.detok import IncrementalDetok, \
    default_decode  # noqa: F401
from repro_torch.serving.engine import ADMISSION_POLICIES, Engine  # noqa: F401
from repro_torch.serving.http import ApiServer  # noqa: F401
from repro_torch.serving.kv_cache import KVCache  # noqa: F401
from repro_torch.serving.prefix_cache import PrefixIndex  # noqa: F401
from repro_torch.serving.request import Request, Result  # noqa: F401
from repro_torch.serving.runner import ModelRunner  # noqa: F401
from repro_torch.serving.sampling import sample, \
    sample_per_slot  # noqa: F401
from repro_torch.serving.scheduler import Scheduler  # noqa: F401
