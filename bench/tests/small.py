"""Small versions of the benchmark's configurations and mixes, for runs
of the harness on the CPU: the same families, layouts and semantics at
widths a test holds, served in float32 so that the program's plain path
and the reference agree to rounding."""
import copy

from bench.harness import spec

MAMBA = {"hidden_size": 64, "intermediate_size": 128, "state_size": 4,
         "time_step_rank": 8, "num_hidden_layers": 2, "vocab_size": 512,
         "torch_dtype": "float32",
         "port": {"registry": "falcon-mamba-7b", "replace": {
             "d_model": 64, "vocab": 512, "n_layers": 2, "dtype": "float32",
             "ssm": {"d_state": 4, "dt_rank": 8, "conv_dim": 4,
                     "expand": 2}}}}
MOE = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
       "head_dim": 16, "num_experts": 4, "num_experts_per_tok": 2,
       "moe_intermediate_size": 32, "num_hidden_layers": 2,
       "vocab_size": 512, "torch_dtype": "float32",
       "port": {"registry": "qwen3-moe-30b-a3b", "replace": {
           "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
           "vocab": 512, "n_layers": 2, "dtype": "float32",
           "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 32,
                   "group_size": 16}}}}
SMALL = {"falcon-mamba-7b": MAMBA, "qwen3-moe-30b-a3b": MOE}
#: the cells the small runs stand for: the benchmark's, and a qwen3 cell
#: that waits for a comparison that separates (PERF.md, open questions)
CELLS = {name: {"name": name, "config": config, "traffic": traffic,
                "chips": 1}
         for name, config, traffic in [
             ("falcon-mamba-7b.prefill", "falcon-mamba-7b", "prefill"),
             ("qwen3-moe-30b-a3b.prefill-long", "qwen3-moe-30b-a3b",
              "prefill-long")]}
#: float32 on both sides: agreement to rounding
LIMITS = {"logit_err": 1e-3, "misplaced": 0, "unserved": 0}


def config(name: str, dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(spec.config(name))
    small = copy.deepcopy(SMALL[name])
    cfg.update(small)
    cfg["torch_dtype"] = dtype
    cfg["port"]["replace"]["dtype"] = dtype
    if "group_size" in cfg["semantics"]:
        cfg["semantics"]["group_size"] = 16
    return cfg


def mix(name: str = "prefill") -> dict:
    m = copy.deepcopy(spec.traffic(name))
    m["lengths"] = {"law": "log_uniform", "min": 24, "max": 96, "cycle": 4}
    m["sessions"] = 3
    m["compare"] = {"requests": 2}
    m["profile"] = {"requests": 2}
    return m
