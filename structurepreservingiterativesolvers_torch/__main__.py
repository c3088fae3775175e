from .experiments.cli import main

main()
