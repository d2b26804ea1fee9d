"""Training parity for the two architectures with a stub frontend at
their reduced configs against ``jax.value_and_grad(train_loss)``:
PaliGemma (prefix-LM over stub image embeddings; the loss over the text
positions only) and Whisper (encoder-decoder with cross-attention, each
self+cross block rematerialised)."""
import pytest

import _torch_train as T

ARCHS = ["paligemma_3b", "whisper_tiny"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return T.reference(request.param)


def test_train_loss_and_gradients_match_reference(ref):
    T.assert_matches(ref)
