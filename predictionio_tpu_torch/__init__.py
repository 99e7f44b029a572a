"""PyTorch/CUDA port of predictionio_tpu: ALS serving, training, the
event-to-release lifecycle, online fold-in, staged rollouts, and the four
ALS engines (recommendation, e-commerce, similar-product with
cooccurrence, recommended-user), and evaluation (``pio eval``: metrics,
k folds and the batched hyperparameter sweep).

The JAX package ``predictionio_tpu`` is the reference this package is held
against; module paths mirror it so each counterpart is easy to find. This
package imports ``torch``, numpy and the standard library only — never
``jax`` and nothing under ``predictionio_tpu`` (``tests/test_torch_guard.py``
checks both).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (``--device cpu`` on the CLI); without a card and without
that request it raises (:func:`predictionio_tpu_torch.utils.device.resolve_device`).
"""

__version__ = "0.1.0"
