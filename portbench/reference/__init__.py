"""The plain reference: frozen copies of the port's plain modules
(`plain/`, each file naming its source) and what drives them against a
run. Nothing here imports the program or JAX."""
