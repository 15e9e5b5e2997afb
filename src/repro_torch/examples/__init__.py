"""The twins of the repository's ``examples/``, one module each, run as
``python -m repro_torch.examples.<name>``: ``quickstart`` (the plan
service's submit -> ticket -> compile -> execute flow), ``serve_lm``
(continuous batching on a hot-swapped page pool), ``train_lm`` (a ~100M
dense LM through the trainer) and ``banking_explorer`` (the four banking
systems on a benchmark pattern).  Each takes the JAX package's example's
flags and prints its lines; those that touch a device also take
``--device`` (default ``cuda``, which raises without a card)."""
