"""Loading a benchmark-made state dict into the program's model by key."""

from __future__ import annotations

import torch


def load_by_key(net: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """Copy ``sd`` into ``net`` by key. Every parameter and statistic of the
    program's model must be given, with its shape, and nothing else
    (BatchNorm step counters excepted): a model that differs from the
    reference's structure raises."""
    own = net.state_dict()
    want = {k for k in own if not k.endswith("num_batches_tracked")}
    if want != set(sd):
        raise ValueError(f"state dict keys differ: program only {sorted(want - set(sd))[:5]}, "
                         f"reference only {sorted(set(sd) - want)[:5]}")
    for k in want:
        if tuple(own[k].shape) != tuple(sd[k].shape):
            raise ValueError(f"{k}: program {tuple(own[k].shape)}, reference {tuple(sd[k].shape)}")
    net.load_state_dict({**{k: own[k] for k in own if k not in want}, **sd})
    return net
