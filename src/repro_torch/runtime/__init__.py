"""The runtime layer over the pilots: straggler mitigation
(``stragglers``), checkpoint/restart through pilot loss
(``fault_tolerance``) and the elastic mesh (``elastic``: re-forming the
mesh over the survivors and resharding state onto it)."""
