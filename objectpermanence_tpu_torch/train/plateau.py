"""ReduceLROnPlateau with torch semantics (mode=min, rel threshold 1e-4), the
port's copy of `objectpermanence_tpu/train/plateau.py`. The training loop
sets the returned learning rate on the optimizer's `param_groups`; it steps
on the epoch-end training loss.
"""

from dataclasses import dataclass, field


@dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.8
    patience: int = 2
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = field(default=float("inf"))
    num_bad_epochs: int = field(default=0)

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) lr."""
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if new_lr < self.lr:
                print(f"ReduceLROnPlateau: reducing learning rate to {new_lr:.6g}")
            self.lr = new_lr
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]
