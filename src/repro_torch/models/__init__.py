"""The LM stack for serving: decoder blocks and the model (prefill and
cached greedy decode) in PyTorch, the counterpart of ``repro.models`` for
the GQA attention and MoE blocks."""
