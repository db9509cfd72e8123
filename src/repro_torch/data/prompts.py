# Copy of repro/data/prompts.py (framework-free).
"""The paper's Table-2 SBS prompt set (61 prompts), used by the threshold
benchmark (Fig. 3) and the serving examples."""

PAPER_PROMPTS = [
    "An armchair in the shape of an avocado",
    "An old man is talking to his parents",
    "A grocery store refrigerator has pint cartons of milk on the top shelf, "
    "quart cartons on the middle shelf, and gallon plastic jugs on the bottom shelf",
    "An oil painting of a couple in formal evening wear going home get caught "
    "in a heavy downpour with no umbrellas",
    "Paying for a quarter-sized pizza with a pizza-sized quarter",
    "Wild turkeys in a garden seen from inside the house through a screen door",
    "A watercolor of a silver dragon head",
    "A watercolor of a silver dragon head with flowers",
    "A watercolor of a silver dragon head with colorful flowers",
    "A watercolor of a silver dragon head with colorful flowers growing out of the top",
    "A watercolor of a silver dragon head with colorful flowers growing out of "
    "the top on a colorful smooth gradient background",
    "A red basketball with flowers on it, in front of blue one with a similar pattern",
    "A Cubism painting of a happy dragon with colorful flowers growing out of its head",
    "A cyberpunk style illustration of a dragon head with flowers growing out of "
    "the top with a rainbow in the background, digital art",
    "A Hokusai painting of a happy dragon head with flowers growing out of the top",
    "A Salvador Dali painting of 3 dragon heads",
    "A Leonardo Da Vinci painting of 3 dragon heads and 2 roses",
    "3d rendering of 5 tennis balls on top of a cake",
    "A person holding a drink of soda",
    "A person is squeezing a lemon",
    "A person holding a cat",
    "A red ball on top of a blue pyramid with the pyramid behind a car that is "
    "above a toaster",
    "A boy is watching TV",
    "A photo of a person dancing in the rain",
    "A photo of a boy jumping over a fence",
    "A photo of a boy is kicking a ball",
    "A path in a forest with tall trees",
    "A sunset with a cloudy sky and a field of grass",
    "A dirt road that has some grass on it",
    "A beach with a lot of waves on it",
    "A road that is going down a hill",
    "A rocky shore with waves crashing on it",
    "Abraham Lincoln touches his toes while George Washington does chin-ups "
    "Lincoln is barefoot",
    "A snowy forest with trees covered in snow",
    "A path in a forest with tall trees",
    "A path through a forest with fog and trees",
    "A field with a lot of grass and mountains in the background",
    "A waterfall with a tree in the middle of it",
    "A foggy sunrise over a valley with trees and hills",
    "A beach with a cloudy sky above it",
    "A black and white photo of a mountain range",
    "A mountain range with snow on top of it",
    "A picture of a one-dollar money bill",
    "Supreme Court Justices play a baseball game with the FBI",
    "A picture of a Red Robin",
    "A picture of Coco Cola can",
    "A picture of Costco store",
    "A high-quality photo of a golden retriever flying a yellow floatplane",
    "A profile photo for a smart, engaging digital assistant",
    "A picture of a multilingual Bert hanging out with Elmo and Ernie",
    "A molecular diagram showing why ice is less dense than water",
    "A historical painting showing the invention of the wheel",
    "A picture of water pouring out of a jar in outer space",
    "Futuristic view of Delhi when India becomes a developed country as digital art",
    "A donkey and an octopus are playing a game The donkey is holding a rope on "
    "one end, the octopus is holding onto the other The donkey holds the rope "
    "in its mouth",
    "A mirrored view of the Great Sphinx of Giza as digital art",
    "Concept art of the next generation cloud-based game console",
    "A silver dragon head",
    "A pear cut into seven pieces arranged in a ring",
    "A tomato has been put on top of a pumpkin on a kitchen stool. There is a "
    "fork sticking into the pumpkin",
    "An elephant is behind a tree",
]

assert len(PAPER_PROMPTS) == 61
