"""Serving: the bucketed STDService with its batching helpers, and LM
prefill + greedy decode (``serve_lm``)."""
