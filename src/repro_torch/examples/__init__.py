"""The examples, each ``python -m repro_torch.examples.<name>`` (on the card
unless ``--device cpu``): ``quickstart``, ``distributed_index``,
``knnlm_serve`` and ``train_lm``.  Each ``main(argv)`` prints what the
JAX package's example prints and returns its results."""
