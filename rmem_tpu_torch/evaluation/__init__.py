from rmem_tpu_torch.evaluation.evaluation import Evaluation  # noqa: F401
from rmem_tpu_torch.evaluation.metrics import (  # noqa: F401
    db_eval_iou, db_statistics)
