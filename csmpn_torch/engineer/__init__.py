from .config import load_module, parse_args  # noqa: F401
from .fire import fire  # noqa: F401
from .trainer import Trainer  # noqa: F401
from .metrics import Loss, Metric, MetricCollection  # noqa: F401
from .checkpoint import Checkpoint  # noqa: F401
from .loggers import ConsoleLogger  # noqa: F401
from .schedulers import cosine_annealing_schedule  # noqa: F401
from .seed import set_seed  # noqa: F401
