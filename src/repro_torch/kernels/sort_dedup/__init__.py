"""Sort and run fold of a triple batch: ``assoc.from_triples`` and
``assoc._combine_sorted`` on the card."""
from . import ops  # noqa: F401
