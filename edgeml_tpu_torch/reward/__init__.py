from .orie import compute_rewards, dcsb_rewards, orie_rewards

__all__ = ["compute_rewards", "orie_rewards", "dcsb_rewards"]
