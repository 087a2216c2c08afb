"""Perplexity and teacher-forced scoring (``ppl``), the evaluation CLI
(``python -m nf4_tpu_torch.eval``) and the trained-in-place quality gate
(``python -m nf4_tpu_torch.eval.quality_gate``)."""
