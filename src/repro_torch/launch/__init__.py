# Launchers of the port: ``train`` (the LLM-scale FL host loop).
