"""Host-side model of the APEnet+ fabric: torus, APElink, TLB, RDMA, and the
CollectiveSchedule IR (``core.fabric``).  Pure Python and NumPy."""
