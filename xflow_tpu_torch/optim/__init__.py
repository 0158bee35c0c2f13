from xflow_tpu_torch.optim.base import Optimizer
from xflow_tpu_torch.optim.ftrl import FTRL
from xflow_tpu_torch.optim.sgd import SGD


def make_optimizer(cfg) -> Optimizer:
    if cfg.optimizer == "ftrl":
        return FTRL(
            alpha=cfg.alpha, beta=cfg.beta, lambda1=cfg.lambda1, lambda2=cfg.lambda2
        )
    if cfg.optimizer == "sgd":
        return SGD(lr=cfg.sgd_lr)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


__all__ = ["Optimizer", "FTRL", "SGD", "make_optimizer"]
