from repro_torch.obs.metrics import MetricsLogger, git_sha

__all__ = ["MetricsLogger", "git_sha"]
