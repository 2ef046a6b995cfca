"""Plain references of the benchmark's model families.

Each module gives ``logits(cfg, params, tokens, prompt_len, first,
precision)``: the whole sequence ``tokens`` through the model in one
causal forward pass, in float32 (``precision="f32"``, TF32 off) or with
every matrix product's operands rounded to float8 e4m3 (``"fp8"``, the
control), and the logits at positions ``first`` and after.  They read
``cfg`` (a configuration file of ``lcxbench/configs/``) and the weights
the benchmark drew, in the nest ``lcxbench.weights`` describes, and
import nothing but ``torch`` and the standard library.
"""
