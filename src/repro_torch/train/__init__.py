"""LM training: AdamW, the train step and the fault-tolerant trainer."""
