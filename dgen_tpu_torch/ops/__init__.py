"""Bill, cashflow, dispatch and sizing operations of the port."""
