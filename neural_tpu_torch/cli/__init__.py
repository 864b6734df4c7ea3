"""The port's command-line tools, each run as ``python -m
neural_tpu_torch.cli.<name>`` and each with the flags of the JAX package's
script of the same use (``scripts/<name>.py``) plus ``--device`` (the card
unless ``--device cpu``): ``run``, ``inference``, ``quantize``,
``convert``, ``perplexity``, ``accuracy``, ``whisper`` and the accuracy
``gate``. Each module's ``main(argv)`` is what the command runs."""
