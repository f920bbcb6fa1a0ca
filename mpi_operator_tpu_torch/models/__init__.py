"""Models of the port: Llama and Mixtral (decode and training paths), ResNet-50/101 and the MNIST CNN."""
