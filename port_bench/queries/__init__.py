"""One module an analytic named by a traffic file: how to call the port's
public entry, and the nominal edges and compulsory bytes of one query."""
