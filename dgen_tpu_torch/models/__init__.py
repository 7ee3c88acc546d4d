"""Population, scenario, market and simulation models of the port."""
