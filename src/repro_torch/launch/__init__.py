"""The launch tier: abstract input and cache trees and their partition
specs (``inputs``), meshes of ranks and a spawner of them (``mesh``), the
analytic roofline at the H100's peaks (``roofline``) and the dry run over
every architecture and run shape, on one card or a production mesh
(``dryrun``)."""
