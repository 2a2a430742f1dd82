"""assemble_ms.sweep: device ms a traced call spends in the band's
assembly, the program's ``band.assemble`` spans summed (mesh1k.mc16k;
moves solves_per_s)."""

from portbench.spans import assemble_ms as read  # noqa: F401
