"""Small stand-ins for the cells, run on the CPU by the tests: the port's
reduced presets and short mixes of the same kinds."""
import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

DENSE = {"name": "dense-small", "arch": "chameleon-34b",
         "policy": "bf16:dense:hopper", "control_policy": "fp8:dense:hopper",
         "input": "tokens", "hidden_size": 128, "intermediate_size": 344,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 512,
         "rope_theta": 10000.0, "rms_norm_eps": 1e-05, "reduced": {}}
MOE = {"name": "moe-small", "arch": "granite-moe-3b-a800m",
       "policy": "bf16:dense:hopper", "control_policy": "fp8:dense:hopper",
       "input": "tokens", "hidden_size": 128, "intermediate_size": 64,
       "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 515,
       "rope_theta": 10000.0, "rms_norm_eps": 1e-05,
       "num_local_experts": 8, "num_experts_per_tok": 2,
       "moe": {"capacity_factor": 1.25, "group_tokens": 64,
               "aux_loss_weight": 0.01}, "reduced": {}}


def mix(name: str, **over) -> dict:
    m = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    m = copy.deepcopy(m)
    m.update(over)
    return m


CHAT = dict(clients=4, batch_slots=4, max_len=64,
            prompt={"lo": 8, "hi": 24, "long_lo": 24, "long_hi": 40,
                    "long_frac": 0.1},
            output={"lo": 6, "hi": 12}, pool=2048,
            check={"requests": 3, "min_tokens": 40})
# The stand-ins' limits, set as a cell's are, from their own readings on
# the CPU: the largest of the program's on seeds 31-36 (chat) or 41-46
# (training), the smallest of the control's (fp8:dense:hopper) and of a
# half batch's on three of them.
# chat: program <= 0.0037; control 0.027-0.167
CHAT_LIMITS = {"widest_gap": 0.012}
# dense: loss <= 2.6e-4 (half 0.011); gradient <= 2.7e-3 (half 0.11);
# change <= 8.3e-3 (control 0.996)
# moe: loss <= 1.4e-3 (half 0.029); gradient <= 0.015 (control 1.0);
# change <= 0.020 (half 0.26)
TRAIN_LIMITS = {
    "dense": {"loss_gap": 2e-3, "grad_norm_gap": 0.02,
              "change_norm_gap": 0.05},
    "moe": {"loss_gap": 6e-3, "grad_norm_gap": 0.1, "change_norm_gap": 0.08}}
TRAIN = dict(batch=2, seq=32)


def arch(conf: dict):
    """The port's ArchConfig for a stand-in: its arch's reduced preset."""
    from perfbench.harness import bench
    from repro_torch.configs import get_reduced
    return bench.arch_config(conf, get_reduced(conf["arch"]))


def ctx(cell, seed, seconds, device, conf, mix, limits, fault=None):
    """A run's context for a stand-in configuration and mix."""
    from perfbench.harness import bench
    return bench.make_ctx(cell, seed, seconds, False, device, spec={},
                          conf=conf, mix=mix, limits=limits, fault=fault,
                          cfg=arch(conf))
