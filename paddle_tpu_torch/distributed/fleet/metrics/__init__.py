from .metric import acc, all_reduce_metrics, auc, max, mean, min, rmse, sum  # noqa: F401

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "mse", "acc", "mean",
           "all_reduce_metrics"]

from .metric import mae, mse  # noqa: F401
