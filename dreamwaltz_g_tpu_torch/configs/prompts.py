"""Named avatar prompt sets for the multi-prompt batch mode.

The port's own copy of ``dreamwaltz_g_tpu/configs/prompts.py`` (the port
imports nothing of the JAX package): the same sets, slugs and parsing, so
one ``--guide.text_set`` resolves to the same prompts in both packages.

``get_avatar_list(name)`` returns a list of (short_name, full_prompt)
pairs; ``--guide.text_set name`` or ``name,lo-hi`` selects a 1-based
inclusive slice, and a path to a ``.txt`` file (one prompt per line, '#'
comments) is read with ``read_txt_file``. The sets: 'demo', 'characters'
(well-known characters), 'everyday', 'diverse', 'creative' and the 'eval'
roster drawn across them.
"""
import os.path as osp
import re
from typing import Dict, List, Tuple

Prompt = Tuple[str, str]

_SUFFIX = ", full body, 3d model, best quality, highly detailed"


def _slug(text: str) -> str:
    s = re.sub(r"[^a-z0-9]+", "_", text.lower()).strip("_")
    return s[:48]


def _named(texts: List[str]) -> List[Prompt]:
    return [(_slug(t), t) for t in texts]


# Widely-known characters and public figures (the 'dreamwaltz'-style
# roster — names are shared facts; descriptions are our own phrasing).
_CHARACTERS = [
    "Abraham Lincoln wearing his black suit and top hat",
    "Albert Einstein in a gray wool suit",
    "Albus Dumbledore with long silver beard and wizard robes",
    "Alice from Wonderland in her blue dress and apron",
    "Batman in his dark armored suit and cape",
    "Barack Obama in a navy suit",
    "Black Widow in her black tactical suit",
    "Buzz Lightyear in his white and green space ranger suit",
    "Captain America with his star-emblazoned uniform and shield",
    "Captain Jack Sparrow with dreadlocks, tricorn hat and pirate coat",
    "Captain Marvel in her red and blue suit with gold star",
    "Chaplin as the Tramp with bowler hat and cane",
    "Cinderella in her sparkling blue ball gown",
    "Darth Vader in black armor with flowing cape",
    "Deadpool in his red and black suit with katanas",
    "Doctor Strange with goatee and red levitating cloak",
    "Doctor Who with a long brown coat and suit",
    "Elsa in her icy blue dress with platinum blond braid",
    "Forrest Gump in a beige suit holding a box of chocolates",
    "Gandalf the Grey with staff and pointed hat",
    "Goku with spiky black hair and orange gi",
    "Green Arrow in his hooded green leather suit",
    "Harley Quinn with pigtails and red and blue jacket",
    "Harry Potter as an adult in Hogwarts robes with glasses",
    "Hatsune Miku with long turquoise twin-tails",
    "Homer Simpson in a white shirt and blue trousers",
    "Hulk with green skin and torn purple shorts",
    "Iron Man in his red and gold armor",
    "Jasmine in her turquoise outfit with gold jewelry",
    "Joker with green hair and a purple suit",
    "Kobe Bryant in his purple and gold basketball jersey",
    "Kratos with ash-white skin and red tattoo",
    "Lara Croft in her adventurer outfit with twin holsters",
    "Link in his green tunic and cap with sword and shield",
    "Lionel Messi in a blue and red striped football kit",
    "Lord Voldemort in flowing black robes",
    "Luke Skywalker in his Jedi robes with lightsaber",
    "Luffy in his red vest and straw hat",
    "Marie Antoinette in an extravagant rococo gown",
    "Mario the plumber in red cap and blue overalls",
    "Merida with wild curly red hair and a bow",
    "Michael Jackson in a red leather jacket and white glove",
    "Michael Jordan in his red basketball uniform",
    "Mulan in warrior armor with a sword",
    "Napoleon in his military uniform and bicorne hat",
    "Naruto Uzumaki in his orange ninja outfit",
    "Neo in a long black coat and sunglasses",
    "Optimus Prime the red and blue robot",
    "Peter Pan in his green outfit and feathered cap",
    "Pinocchio the wooden puppet boy",
    "Princess Leia in her white robe with side buns",
    "Queen Elizabeth II in a pastel coat and hat",
    "Rapunzel with extremely long golden hair",
    "Ronald Weasley in a knitted sweater",
    "Rose from Titanic in her red evening gown",
    "Saber in her blue and silver armored dress",
    "Sailor Moon in her sailor uniform with long blond twin-tails",
    "Santa Claus with a red suit and white beard",
    "Sherlock Holmes in a deerstalker hat and caped coat",
    "Snow White in her yellow and blue dress",
    "Spiderman in his red and blue web-patterned suit",
    "Stormtrooper in white plastoid armor",
    "Sun Wukong the Monkey King in golden armor",
    "Superman in his blue suit with red cape",
    "Tarzan in a loincloth with wild hair",
    "Taylor Swift in a sparkling stage dress",
    "Thanos with purple skin and golden armor",
    "Thor with red cape and hammer",
    "Tinker Bell the fairy in a green dress with wings",
    "Wonder Woman in her armored red and gold suit",
    "Woody the cowboy doll with yellow plaid shirt",
    "Wolverine in his yellow and blue suit with claws",
    "Yoda the small green Jedi master in robes",
]

# Everyday-people descriptions (the 'chatgpt'-style roster, own phrasing).
_EVERYDAY = [
    "a chef in a crisp white coat and tall toque",
    "a college student in a hoodie carrying a backpack",
    "a firefighter in full turnout gear holding a helmet",
    "a gardener in denim overalls and a straw hat",
    "a hiker in rugged boots with a loaded backpack",
    "a lifeguard in red shorts with a whistle",
    "a musician in a worn leather jacket with a guitar",
    "a nurse in teal scrubs with a stethoscope",
    "a scientist in a lab coat and safety goggles",
    "a skateboarder in baggy jeans and a graphic tee",
    "a street artist with paint-spattered clothes",
    "a teenager in torn jeans and a beanie",
    "a woman in a tailored business suit with a briefcase",
    "a woman in a flowing floral sundress",
    "a yoga instructor in comfortable athleisure",
    "a young man in a sharp charcoal suit",
    "an elderly gentleman in a tweed jacket and bowtie",
    "an elderly woman in a floral dress and sunhat",
]

# Diverse body types, ethnicities and occupations (the 'dreamhuman'-style
# roster, own phrasing).
_DIVERSE = [
    "a Black female surgeon in an operating gown",
    "a Black man in a green t-shirt and jeans",
    "a Black woman in an elegant wedding dress",
    "a Buddhist monk in saffron robes",
    "a Mediterranean man with a beard in a white linen shirt",
    "a Roman soldier in segmented armor with a red cloak",
    "a Spanish flamenco dancer in a ruffled red dress",
    "a Viking warrior with a braided beard and fur cloak",
    "a ballerina in a white tutu and pointe shoes",
    "a bedouin dressed in flowing white robes",
    "a bodybuilder in a tank top",
    "a boxer with gloves and championship shorts",
    "a farmer in a plaid shirt and work boots",
    "a female professor in full academic regalia",
    "a karate master wearing a black belt",
    "a man in a Hawaiian shirt, sunglasses and shorts",
    "a man in a Christmas sweater",
    "a man with dreadlocks in a denim jacket",
    "a medieval European king in ermine-trimmed robes",
    "a ninja in black garb with a katana",
    "a plus-size model in silk pyjamas",
    "a policewoman in uniform",
    "a pregnant person of color in a comfortable dress",
    "a rock band member with studded leather and wild hair",
    "a security guard in a dark uniform",
    "a slim man in a navy blazer and gray trousers",
    "a track and field athlete in a racing kit",
    "a woman in traditional Bavarian clothing",
    "a woman in ski clothes with goggles on her helmet",
    "a woman with long blond hair in a long dress",
    "an African woman in traditional printed clothes",
    "an Asian man in a navy suit",
    "an Indian bride in a traditional red dress",
    "an elderly man in a beige suit",
    "a person in a vintage brass diving suit",
    "a person in an ornate Venice Carnival costume",
]

# Cross-matched outfits (the 'creative'-style roster, own phrasing).
_CREATIVE = [
    "a boxer wearing a striped swimsuit",
    "a chef in a lab coat and safety goggles",
    "a clown in a superhero costume with a cape",
    "a doctor in a sunhat holding a bouquet of flowers",
    "a lifeguard in a three-piece business suit",
    "a chubby little boy in a sharp business suit",
]

PROMPT_SETS: Dict[str, List[Prompt]] = {
    # compact demo set (kept for scripted examples)
    "demo": [
        ("wizard", "a wizard with a long beard wearing a blue robe and pointed hat" + _SUFFIX),
        ("knight", "a medieval knight in polished steel plate armor" + _SUFFIX),
        ("astronaut", "an astronaut in a white space suit with gold visor" + _SUFFIX),
        ("chef", "a cheerful chef in a white uniform and toque" + _SUFFIX),
        ("pirate", "a pirate captain with a tricorn hat and red coat" + _SUFFIX),
        ("robot", "a sleek humanoid robot with glowing blue accents" + _SUFFIX),
        ("ballerina", "a ballerina in a white tutu" + _SUFFIX),
        ("firefighter", "a firefighter in full turnout gear with helmet" + _SUFFIX),
        ("samurai", "a samurai wearing ornate lacquered armor" + _SUFFIX),
        ("detective", "a detective in a trench coat and fedora" + _SUFFIX),
        ("viking", "a viking warrior with a braided beard and fur cloak" + _SUFFIX),
        ("sorceress", "a sorceress in a flowing purple gown with silver jewelry" + _SUFFIX),
    ],
    "characters": _named(_CHARACTERS),
    "everyday": _named(_EVERYDAY),
    "diverse": _named(_DIVERSE),
    "creative": _named(_CREATIVE),
}
# eval roster drawn across the sets (the 'seeavatar'/'gavatar' analog)
PROMPT_SETS["eval"] = (PROMPT_SETS["characters"][:8]
                       + PROMPT_SETS["diverse"][:8]
                       + PROMPT_SETS["creative"][:4])


def read_txt_file(txt_path: str) -> List[str]:
    """One prompt per line; '#' lines are comments."""
    out = []
    with open(txt_path) as f:
        for line in f:
            line = line.strip("\r\n ,.")
            if not line or line.startswith("#"):
                continue
            out.append(line)
    return out


def get_avatar_list(name: str) -> List[Prompt]:
    """Resolve a prompt set spec: 'demo', 'demo,2-5' (a 1-based inclusive
    slice) or a path to a .txt file."""
    if "," in name:
        name, rng = name.split(",", 1)
        lo, hi = (int(x) for x in rng.split("-")) if "-" in rng else (int(rng), int(rng))
    else:
        lo, hi = 1, None
    if name not in PROMPT_SETS and osp.isfile(name):
        prompts = _named(read_txt_file(name))
    else:
        prompts = PROMPT_SETS[name]
    return prompts[lo - 1: hi] if hi is not None else prompts[lo - 1:]
