"""Options of the JAX package's signatures that the port does not take.

Every public function of the port takes the JAX package's parameters in its
order, so a call written for one package runs on the other. A TPU tiling
knob (block sizes, Pallas interpret mode) is accepted at its JAX default
and raises ``NotImplementedError`` naming it at any other value.
"""

from __future__ import annotations


def reject_unported(fn: str, **options) -> None:
    """Raise NotImplementedError for the first option not at its default.

    Each keyword maps to (value, JAX default); a None default is left only by
    None, any other by an equal value."""
    for name, (value, default) in options.items():
        moved = value is not None if default is None else value != default
        if moved:
            raise NotImplementedError(
                f"{fn}: {name}={value!r} is not ported to the PyTorch port "
                f"(only its default, {default!r})")
