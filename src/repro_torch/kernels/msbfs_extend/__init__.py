"""MS-BFS block extension kernel."""
