"""Entry points of the port: the command line, the HTTP server and the gradio UI."""
