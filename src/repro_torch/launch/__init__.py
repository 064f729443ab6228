"""The launch tier on one card: abstract input and cache trees
(``inputs``), the analytic roofline at the H100's peaks (``roofline``)
and the dry run over every architecture and run shape (``dryrun``).
The multi-card half (meshes and partition specs) is not ported yet."""
