"""Static checks of a model spec before it reaches the card.

The port's smallest counterpart of ``stateright_tpu/analysis``: only the
admission mode of its ``cli.py`` (``admission.py``), which the checker
service runs in a subprocess at submit. The reference's jaxpr, lowering and
compile-plan rules (STPU001-008) have no meaning before ROADMAP A10d.
"""
