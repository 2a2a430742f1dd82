"""sync_wait_ms.host: host ms a traced call blocks in the program's
``cg.sync`` spans, the CG continuation tests: device work that issuing
did not hide (grid1024.knight; moves call_ms_p95.host)."""

from portbench.spans import sync_wait_ms as read  # noqa: F401
