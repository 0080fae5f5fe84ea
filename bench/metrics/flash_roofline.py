"""The least time the attention of the prompts admitted in the traced
stretch needs (each prompt once: its causal attention in every layer at
the bf16 peak or its q, k, v and output bytes at the HBM rate, whichever
is longer), over the device time of the flash kernels
(``flash_*``, by name from the trace) in that stretch, in %.  The work is
counted once a document whatever computes it, so a kernel that runs
twice for one prompt reads at most 50 %."""

from bench.harness import flops


def read(run):
    tr = run.get("trace")
    if tr is None or not run.get("traced_prompts"):
        return None
    dev = tr.device_s("flash_")
    if dev <= 0:
        return None
    cf = run["config"]
    peak = float(cf["compute"]["peak_flops_per_s"])
    need = sum(flops.prompt_attention_bound_s(cf, n, peak)[0]
               for n in run["traced_prompts"])
    return 100.0 * need / dev
