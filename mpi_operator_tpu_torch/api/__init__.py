"""The operator's contract with a workload process, as the port reads it
(``constants``: the environment the controller injects)."""
