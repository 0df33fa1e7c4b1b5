"""The LM substrate's models: layers, MLP, attention, RWKV-6 and the
assembled LM (``lm.py``)."""
