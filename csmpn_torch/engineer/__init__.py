from .config import load_module, parse_args  # noqa: F401
from .fire import fire  # noqa: F401
from .trainer import Trainer  # noqa: F401
from .metrics import (  # noqa: F401
    Accuracy,
    BinaryAUROC,
    Loss,
    LorentzMetric,
    Metric,
    MetricCollection,
    RMSRE,
    RRMSE,
)
from .checkpoint import Checkpoint  # noqa: F401
from .loggers import ConsoleLogger, WANDBLogger  # noqa: F401
from .schedulers import (  # noqa: F401
    cosine_annealing_schedule,
    cosine_cyclic_schedule,
)
from .seed import set_seed  # noqa: F401
