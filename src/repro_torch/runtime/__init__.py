"""The runtime layer over the pilots: straggler mitigation
(``stragglers``), checkpoint/restart through pilot loss
(``fault_tolerance``) and the elastic device grid (``elastic``)."""
