"""Traffic: the frozen query generator and the one generator of every mix."""
